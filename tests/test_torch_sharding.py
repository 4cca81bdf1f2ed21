"""The port's snarl mesh (stoat_tpu_torch/parallel) on the CPU.

A mesh is a list of devices, here the CPU named several times (``[cpu] *
n``, the counterpart of conftest.py's virtual devices), and
``parallel.mesh.steps`` deals a chromosome's chunks over it.  The rule's
cases run on tests/test_sharding.py's fixture; every mode's tables come
from the port's entry point, ``run_vcf_analysis`` with ``mesh=``, at
chunks of ceil(S / n) snarls (a chunk a device, as many devices as
snarls at n = 40, and more), on the fixtures and draws of
tests/test_sharding.py and tests/test_sharding_quant.py.  They are held
byte for byte to stoat_tpu's runner on conftest.py's 8 virtual devices
(its sharded run), -T tables included.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu.io.snarl_file import parse_snarl_path as j_snarls
from stoat_tpu.pipeline.runner import run_vcf_analysis as j_run
from stoat_tpu.stats.lmm import fit_null_reml as j_fit
from stoat_tpu_torch import parallel as tpar
from stoat_tpu_torch.io.phenotype import (parse_binary_pheno,
                                          parse_quantitative_pheno)
from stoat_tpu_torch.io.snarl_file import parse_snarl_path
from stoat_tpu_torch.io.vcf import VcfReader
from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix
from stoat_tpu_torch.pipeline import permutation as tperm
from stoat_tpu_torch.pipeline import runner as trunner
from stoat_tpu_torch.stats.lmm import fit_null_reml
from stoat_tpu_torch.tables import pack_chromosome_chunks

CPU = torch.device("cpu")
# 40 devices for the 24- and 30-snarl fixtures leave devices idle
SIZES = [1, 2, 3, 4, 8, 40]


def _workload(tmp_path_factory, name, n_samples, n_snarls, seed):
    paths = make_fixture(str(tmp_path_factory.mktemp(name)),
                         n_samples=n_samples, n_snarls=n_snarls, seed=seed)
    pheno_b, samples = parse_binary_pheno(paths["binary"],
                                          list(paths["samples"]))
    return {"paths": paths, "samples": samples, "b": pheno_b,
            "q": parse_quantitative_pheno(paths["quantitative"], samples),
            "n_snarls": n_snarls, "tmp": tmp_path_factory.mktemp(name + "j"),
            "jax": {}}


@pytest.fixture(scope="module")
def binary_workload(tmp_path_factory):
    """tests/test_sharding.py's workload."""
    return _workload(tmp_path_factory, "tshard", 50, 30, 3)


@pytest.fixture(scope="module")
def quant_workload(tmp_path_factory):
    """tests/test_sharding_quant.py's workload."""
    return _workload(tmp_path_factory, "tshardq", 40, 24, 13)


def _mesh(n):
    return tpar.make_snarl_mesh([CPU] * n)


def _same(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


def _tables_equal(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b)) and names, "no tables"
    for name in names:
        _same(os.path.join(dir_a, name), os.path.join(dir_b, name))


def _kinship(n):
    """tests/test_sharding_quant.py's kinship."""
    G = np.random.default_rng(7).normal(size=(n, 8))
    K = G @ G.T / 8
    d = np.sqrt(np.diag(K))
    return K / np.outer(d, d)


def _logistic_pheno(w):
    """tests/test_sharding_quant.py's case-control draw."""
    return np.random.default_rng(0).integers(0, 2, len(w["samples"])
                                             ).astype(bool)


def _port(w, mode, n, out_dir, tables=False, **kw):
    """The port's ``mode`` on a mesh of ``n`` CPU devices at chunks of
    ceil(S / n) snarls; returns the table's path (and -T's directory)."""
    out = os.path.join(out_dir, "port.tsv")
    if mode == "lmm":
        kw["phenotype"] = fit_null_reml(w["q"], _kinship(len(w["q"])))
    elif mode == "binary_covar":
        kw["phenotype"] = _logistic_pheno(w)
    elif mode == "quantitative":
        kw["phenotype"] = w["q"]
    else:
        kw["phenotype"] = w["b"]
    rdir = None
    if tables:
        rdir = os.path.join(out_dir, "regression")
        os.makedirs(rdir)
        kw.update(table_threshold=1.0, regression_dir=rdir)
    trunner.run_vcf_analysis(
        w["paths"]["vcf"], parse_snarl_path(w["paths"]["snarl"]), out,
        device=CPU, mode=mode, sample_names=w["samples"],
        snarl_chunk_size=-(-w["n_snarls"] // n), mesh=_mesh(n), **kw)
    return out, rdir


def _jax(w, mode, tables=False):
    """stoat_tpu's runner on its 8-device mesh, run once a mode; returns
    the table's path (and -T's directory)."""
    key = (mode, tables)
    if key not in w["jax"]:
        base = w["tmp"] / f"{mode}_{int(tables)}"
        base.mkdir()
        out, kw = str(base / "jax.tsv"), {}
        if mode == "lmm":
            kw["lmm_ctx"] = j_fit(w["q"], _kinship(len(w["q"])))
        rdir = None
        if tables:
            rdir = str(base / "regression")
            os.makedirs(rdir)
            kw.update(table_threshold=1.0, regression_dir=rdir)
        j_run(w["paths"]["vcf"], j_snarls(w["paths"]["snarl"]), out, mode,
              binary_phenotype=(_logistic_pheno(w) if mode == "binary_covar"
                                else w["b"]),
              quantitative_phenotype=w["q"], sample_names=w["samples"],
              **kw)
        w["jax"][key] = (out, rdir)
    return w["jax"][key]


def test_make_snarl_mesh():
    """A mesh names its devices in order, any of them several times;
    without a card the default mesh raises rather than becoming the CPU
    (decided here, at run time)."""
    mesh = tpar.make_snarl_mesh(["cpu"] * 3)
    assert mesh.devices == (CPU,) * 3 and len(mesh) == 3
    with pytest.raises(ValueError):
        tpar.make_snarl_mesh([])
    if torch.cuda.is_available():
        assert len(tpar.make_snarl_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.make_snarl_mesh()


# the (chunk, devices) pairs of the JAX layout's cases: a shard of ceil(30 /
# n) snarls a device, and the chunked splits
STEP_CASES = [(-(-30 // n), n) for n in SIZES] + [
    (7, 1), (7, 3), (8, 4), (16, 8), (30, 2), (64, 40)]


@pytest.mark.parametrize("chunk,n", STEP_CASES)
def test_steps_deal_whole_chunks(binary_workload, monkeypatch, tmp_path,
                                 chunk, n):
    """``steps`` deals the runner's chunks whole: each snarl in exactly one
    chunk, in file order; a step is the next n chunks, chunk d of it on
    device d.  The runner on a mesh naming the CPU n times queues each
    chunk once, in order, and uploads the words and the phenotype masks
    once."""
    w = binary_workload
    snarls = parse_snarl_path(w["paths"]["snarl"])["ref"]
    reader = VcfReader(w["paths"]["vcf"])
    _, records = next(iter(reader.chromosome_chunks()))
    matrix = EdgeHaplotypeMatrix(2 * len(w["samples"]))
    for rec in records:
        matrix.add_record(rec)
    reader.close()
    chunks = pack_chromosome_chunks(snarls, matrix, chunk)
    devices = [torch.device("cpu", d) for d in range(n)]
    got = list(tpar.steps(chunks, devices))
    assert [len(step) for step in got] == [
        min(n, len(chunks) - i) for i in range(0, len(chunks), n)]
    for step in got:
        assert [d for d, _c in step] == devices[:len(step)]
    dealt = [c for step in got for _d, c in step]
    assert len(dealt) == len(chunks)
    assert all(a is b for a, b in zip(dealt, chunks))
    ids = [s.snarl_id_str for s in snarls]
    assert [s.snarl_id_str for c in dealt for s in c.snarls] == ids
    assert list(tpar.steps([], devices)) == []

    counts = {"words": 0, "masks": 0}
    queued = []

    def counted(name, real):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return real(*args, **kwargs)
        return wrapper

    def spy(packed, *args, **kwargs):
        queued.append((args[-1], [s.snarl_id_str for s in packed.snarls]))
        return analyze(packed, *args, **kwargs)

    analyze = trunner.binary_analyze_chromosome
    monkeypatch.setattr(trunner, "upload_words",
                        counted("words", trunner.upload_words))
    monkeypatch.setattr(trunner, "pheno_masks",
                        counted("masks", trunner.pheno_masks))
    monkeypatch.setattr(trunner, "binary_analyze_chromosome", spy)
    trunner.run_vcf_analysis(
        w["paths"]["vcf"], parse_snarl_path(w["paths"]["snarl"]),
        str(tmp_path / "out.tsv"), w["b"], CPU, sample_names=w["samples"],
        snarl_chunk_size=chunk, mesh=_mesh(n))
    assert counts == {"words": 1, "masks": 1}
    assert [d for d, _s in queued] == [CPU] * len(chunks)
    assert [s for _d, ids_ in queued for s in ids_] == ids


def test_inputs_uploaded_once_per_device(binary_workload, monkeypatch,
                                         tmp_path):
    """The permutation pass on a mesh naming the CPU four times, two
    chromosomes, both phenotypes: each chromosome's words uploaded once,
    each job's rows and covariates and the tail once a run, and its tables
    those of one device."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=30, n_snarls=24,
                         seed=5, n_chroms=2)
    pheno_b, samples = parse_binary_pheno(paths["binary"],
                                          list(paths["samples"]))
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    calls = {"words": 0, "rows": 0, "upload": 0}

    def counted(name, real):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return wrapper

    outs = {}
    for label, mesh in (("single", None), ("mesh", _mesh(4))):
        for name, attr in (("words", "upload_words"),
                           ("rows", "to_perm_inputs"), ("upload", "upload")):
            monkeypatch.setattr(tperm, attr, counted(name, getattr(tperm,
                                                                   attr)))
        calls.update(dict.fromkeys(calls, 0))
        b, q = str(tmp_path / f"{label}_b"), str(tmp_path / f"{label}_q")
        tperm.run_permutation_test(
            paths["vcf"], parse_snarl_path(paths["snarl"]), b,
            pheno_bin=pheno_b, quantitative_phenotype=pheno_q,
            output_tsv_quant=q, n_perms=20, seed=3, snarl_chunk_size=4,
            device="cpu", mesh=mesh)
        monkeypatch.undo()
        outs[label] = (b, q, dict(calls))
    # two chromosomes; two jobs, each with its covariates ([N, 0]), and one
    # tail (the path tables go through convert.py)
    assert outs["mesh"][2] == outs["single"][2] == {
        "words": 2, "rows": 2, "upload": 3}
    for single, meshed in zip(outs["single"][:2], outs["mesh"][:2]):
        _same(single, meshed)


@pytest.mark.parametrize("n", SIZES)
def test_binary_mesh_parity(binary_workload, tmp_path, n):
    """vcf -b on a mesh of n: stoat_tpu's sharded run, byte for byte."""
    got, _ = _port(binary_workload, "binary", n, str(tmp_path))
    _same(got, _jax(binary_workload, "binary")[0])


# tests/test_sharding_quant.py's meshes, an uneven split and idle devices
# of each
REGRESSION_CASES = [("quantitative", n) for n in (2, 3, 8, 40)] + \
    [("lmm", n) for n in (2, 3, 8, 40)] + \
    [("binary_covar", n) for n in (3, 4, 40)]


@pytest.mark.parametrize("mode,n", REGRESSION_CASES)
def test_regression_mesh_parity(quant_workload, tmp_path, mode, n):
    """vcf -q, the mixed model and vcf -b -c on a mesh of n: stoat_tpu's
    sharded run, byte for byte."""
    got, _ = _port(quant_workload, mode, n, str(tmp_path))
    _same(got, _jax(quant_workload, mode)[0])


@pytest.mark.parametrize("mode", ["quantitative", "lmm", "binary_covar"])
@pytest.mark.parametrize("n", [3, 40])
def test_table_view_gathers_across_shards(quant_workload, tmp_path, mode,
                                          n):
    """-T on a mesh of n: the table and every snarl's table file
    stoat_tpu's sharded run's, byte for byte (each chunk's table view
    stays on its device until its writer asks for rows)."""
    got, rdir = _port(quant_workload, mode, n, str(tmp_path), tables=True)
    want, jdir = _jax(quant_workload, mode, tables=True)
    _same(got, want)
    _tables_equal(rdir, jdir)


@pytest.mark.parametrize("n", [1, 3, 8, 40])
@pytest.mark.parametrize("with_covar", [False, True])
def test_dual_mesh_parity(binary_workload, tmp_path, n, with_covar):
    """The dual ``vcf -b -q`` on a mesh of n: both tables stoat_tpu's
    sharded dual's, byte for byte."""
    w = binary_workload
    N = len(w["samples"])
    rng = np.random.default_rng(11)
    qpheno = rng.standard_normal(N)
    covar = rng.standard_normal((N, 2)) if with_covar else None
    q = str(tmp_path / "port_q.tsv")
    got, _ = _port(w, "binary", n, str(tmp_path), covariate=covar,
                   secondary={"mode": "quantitative", "output_tsv": q,
                              "quantitative_phenotype": qpheno})
    key = ("dual", with_covar)
    if key not in w["jax"]:
        base = w["tmp"] / f"dual_{int(with_covar)}"
        base.mkdir()
        jb, jq = str(base / "b.tsv"), str(base / "q.tsv")
        j_run(w["paths"]["vcf"], j_snarls(w["paths"]["snarl"]), jb,
              "binary", binary_phenotype=w["b"], covariate=covar,
              sample_names=w["samples"],
              secondary={"mode": "quantitative", "output_tsv": jq,
                         "quantitative_phenotype": qpheno})
        w["jax"][key] = (jb, jq)
    for mine, want in zip((got, q), w["jax"][key]):
        _same(mine, want)
