"""The port's runner on a mesh (tests/test_runner_mesh.py's contract): every
``vcf`` mode run with its snarls sharded over a mesh of CPU devices writes
byte-identical TSVs (and -T tables) to the same run on one device, at mesh
sizes 1, 2, 3 (uneven), 4, 8 and 12 (more shards than a chunk has snarls:
empty shards); and the one-device output is stoat_tpu's, byte for byte
(stoat_tpu's runner itself on conftest.py's 8-device mesh).  Also the rule
that picks the mesh: a bare ``cuda`` with more than one card, never the
CPU in its place.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu.io.phenotype import QtlData as JQtl
from stoat_tpu.pipeline.runner import run_vcf_analysis as j_run
from stoat_tpu.stats.lmm import fit_null_reml as j_fit
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.io import (parse_binary_pheno, parse_covariates,
                                parse_quantitative_pheno, parse_snarl_path)
from stoat_tpu_torch.io.phenotype import QtlData
from stoat_tpu_torch.parallel import make_snarl_mesh
from stoat_tpu_torch.parallel import mesh as tmesh
from stoat_tpu_torch.pipeline.runner import run_vcf_analysis
from stoat_tpu_torch.stats.lmm import fit_null_reml

CPU = torch.device("cpu")
SIZES = [1, 2, 3, 4, 8, 12]
CHUNK = 7


def _same(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_runner_mesh.py's fixture (36 samples, 21 snarls, seed
    23), its gene set, and a kinship for the mixed model."""
    tmp = tmp_path_factory.mktemp("trunnermesh")
    paths = make_fixture(str(tmp), n_samples=36, n_snarls=21, seed=23)
    pheno_b, samples = parse_binary_pheno(paths["binary"],
                                          list(paths["samples"]))
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    covar = parse_covariates(paths["covariate"], ["AGE", "SEX"], samples)
    rng = np.random.default_rng(5)
    genes = [(f"gene{i}", rng.standard_normal(len(samples)), 100 + 400 * i,
              300 + 400 * i) for i in range(6)]
    G = np.random.default_rng(9).normal(size=(len(samples), 6))
    K = G @ G.T / 6
    d = np.sqrt(np.diag(K))
    K = K / np.outer(d, d)
    return {"paths": paths, "samples": samples, "b": pheno_b, "q": pheno_q,
            "covar": covar, "genes": genes, "kinship": K, "tmp": tmp,
            "singles": {}}


# mode -> (the runner's mode, covariates?)
MODES = {"binary": ("binary", False), "binary_covar": ("binary_covar", True),
         "quantitative": ("quantitative", False),
         "quantitative_covar": ("quantitative", True),
         "lmm": ("lmm", True)}


def _port(data, mode, out, mesh=None, regression_dir=None, **extra):
    run_mode, with_covar = MODES[mode]
    covar = data["covar"] if with_covar else None
    pheno = {"binary": data["b"], "binary_covar": data["b"],
             "quantitative": data["q"]}.get(run_mode)
    if run_mode == "lmm":
        pheno = fit_null_reml(data["q"], data["kinship"], covar)
    if regression_dir is not None:
        os.makedirs(regression_dir, exist_ok=True)
        extra.update(table_threshold=1.0, regression_dir=regression_dir)
    run_vcf_analysis(data["paths"]["vcf"],
                     parse_snarl_path(data["paths"]["snarl"]), out, pheno,
                     CPU, mode=run_mode, covariate=covar,
                     sample_names=data["samples"],
                     snarl_chunk_size=CHUNK, mesh=mesh, **extra)


def _jax(data, mode, out, regression_dir=None):
    from stoat_tpu.io.snarl_file import parse_snarl_path as j_snarls
    run_mode, with_covar = MODES[mode]
    covar = data["covar"] if with_covar else None
    kw = {}
    if run_mode == "lmm":
        kw["lmm_ctx"] = j_fit(data["q"], data["kinship"], covar)
    if regression_dir is not None:
        os.makedirs(regression_dir, exist_ok=True)
        kw.update(table_threshold=1.0, regression_dir=regression_dir)
    j_run(data["paths"]["vcf"], j_snarls(data["paths"]["snarl"]), out,
          run_mode, binary_phenotype=data["b"],
          quantitative_phenotype=data["q"], covariate=covar,
          sample_names=data["samples"], snarl_chunk_size=CHUNK, **kw)


def _tables_equal(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b)) and names, "no tables"
    for name in names:
        _same(os.path.join(dir_a, name), os.path.join(dir_b, name))


def _single(data, mode, tables=False):
    """The port's one-device output of ``mode`` (made once), checked
    byte for byte against stoat_tpu's runner on its 8-device mesh."""
    key = (mode, tables)
    if key not in data["singles"]:
        base = data["tmp"] / f"single_{mode}_{int(tables)}"
        base.mkdir()
        got, want = str(base / "port.tsv"), str(base / "jax.tsv")
        rdirs = ((str(base / "port_regression"), str(base / "jax_regression"))
                 if tables else (None, None))
        _port(data, mode, got, regression_dir=rdirs[0])
        _jax(data, mode, want, regression_dir=rdirs[1])
        _same(got, want)
        if tables:
            _tables_equal(*rdirs)
        data["singles"][key] = (got, rdirs[0])
    return data["singles"][key]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_runner_matches_single_device(data, mode, n, tmp_path):
    single, _ = _single(data, mode)
    meshed = str(tmp_path / "mesh.tsv")
    _port(data, mode, meshed, mesh=make_snarl_mesh([CPU] * n))
    _same(single, meshed)


@pytest.mark.parametrize("n", [1, 3, 8, 12])
@pytest.mark.parametrize("mode", ["quantitative_covar", "binary_covar",
                                  "lmm"])
def test_mesh_runner_table_dumps_match(data, mode, n, tmp_path):
    """-T: the result TSV and every per-snarl table file equal the
    one-device run's."""
    single, single_dir = _single(data, mode, tables=True)
    meshed, rdir = str(tmp_path / "mesh.tsv"), str(tmp_path / "regression")
    _port(data, mode, meshed, mesh=make_snarl_mesh([CPU] * n),
          regression_dir=rdir)
    _same(single, meshed)
    _tables_equal(single_dir, rdir)


@pytest.mark.parametrize("n", SIZES)
def test_mesh_runner_eqtl_matches_single_device(data, n, tmp_path):
    """eQTL: the design on the mesh's first device, the (snarl, gene)
    pairs split over the mesh."""
    from stoat_tpu.io.snarl_file import parse_snarl_path as j_snarls
    snarls_chr = parse_snarl_path(data["paths"]["snarl"])
    outs = {}
    for label, mesh in (("single", None),
                        ("mesh", make_snarl_mesh([CPU] * n))):
        outs[label] = str(tmp_path / f"{label}.tsv")
        run_vcf_analysis(data["paths"]["vcf"], snarls_chr, outs[label],
                         {"ref": [QtlData(*g) for g in data["genes"]]}, CPU,
                         mode="eqtl", covariate=data["covar"],
                         sample_names=data["samples"],
                         snarl_chunk_size=CHUNK, mesh=mesh)
    want = str(tmp_path / "jax.tsv")
    j_run(data["paths"]["vcf"], j_snarls(data["paths"]["snarl"]), want,
          "eqtl", eqtl_map={"ref": [JQtl(*g) for g in data["genes"]]},
          covariate=data["covar"], sample_names=data["samples"],
          snarl_chunk_size=CHUNK)
    _same(outs["single"], want)
    _same(outs["single"], outs["mesh"])


@pytest.mark.parametrize("n", [1, 3, 8, 12])
@pytest.mark.parametrize("with_covar", [False, True])
def test_mesh_runner_dual_matches_single_device(data, n, with_covar,
                                                tmp_path):
    """The dual ``-b -q`` pass over the mesh: both tables equal the
    one-device dual's, which equal stoat_tpu's."""
    from stoat_tpu.io.snarl_file import parse_snarl_path as j_snarls
    covar = data["covar"] if with_covar else None
    outs = {}
    for label, mesh in (("single", None),
                        ("mesh", make_snarl_mesh([CPU] * n))):
        b, q = str(tmp_path / f"{label}_b.tsv"), str(tmp_path / f"{label}_q")
        run_vcf_analysis(
            data["paths"]["vcf"], parse_snarl_path(data["paths"]["snarl"]),
            b, data["b"], CPU, covariate=covar, sample_names=data["samples"],
            snarl_chunk_size=CHUNK, mesh=mesh,
            secondary={"mode": "quantitative", "output_tsv": q,
                       "quantitative_phenotype": data["q"]})
        outs[label] = (b, q)
    jb, jq = str(tmp_path / "jax_b.tsv"), str(tmp_path / "jax_q.tsv")
    j_run(data["paths"]["vcf"], j_snarls(data["paths"]["snarl"]), jb,
          "binary", binary_phenotype=data["b"], covariate=covar,
          sample_names=data["samples"], snarl_chunk_size=CHUNK,
          secondary={"mode": "quantitative", "output_tsv": jq,
                     "quantitative_phenotype": data["q"]})
    for single, meshed, want in zip(outs["single"], outs["mesh"], (jb, jq)):
        _same(single, want)
        _same(single, meshed)


def test_mesh_secondary_rule(data, tmp_path):
    """An explicit mesh with a secondary other than the dual (or the dual
    with -T) raises, as stoat_tpu does."""
    mesh = make_snarl_mesh([CPU] * 2)
    for secondary, extra in (
            ({"mode": "binary_covar", "binary_phenotype": data["b"]}, {}),
            ({"mode": "quantitative", "quantitative_phenotype": data["q"]},
             {"table_threshold": 1.0, "regression_dir": str(tmp_path)})):
        secondary["output_tsv"] = str(tmp_path / "sec.tsv")
        with pytest.raises(ValueError, match="mesh-sharded secondary"):
            run_vcf_analysis(data["paths"]["vcf"],
                             parse_snarl_path(data["paths"]["snarl"]),
                             str(tmp_path / "out.tsv"), data["b"], CPU,
                             mesh=mesh, secondary=secondary, **extra)


def test_mesh_choice(monkeypatch):
    """resolve_mesh: automatic only for a bare ``cuda`` with more than one
    visible card (every card, in order); ``cuda:N`` and ``cpu`` one
    device; a mesh given is that mesh, whatever the device.  The card
    count is stubbed here: no CUDA call is made."""
    assert tmesh.resolve_mesh("cpu") is None
    assert tmesh.resolve_mesh("cuda", mesh=make_snarl_mesh([CPU])
                              ).devices == (CPU,)
    if not torch.cuda.is_available():
        assert tmesh.resolve_mesh("cuda") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count in (1, 4):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        got = tmesh.resolve_mesh("cuda")
        if count == 1:
            assert got is None
        else:
            assert got.devices == tuple(torch.device("cuda", i)
                                        for i in range(4))
        assert tmesh.resolve_mesh("cuda:0") is None
        assert tmesh.resolve_mesh(torch.device("cuda", 0)) is None
        assert tmesh.resolve_mesh("cpu") is None


def test_cli_keeps_a_bare_cuda_for_the_mesh(data, monkeypatch, tmp_path):
    """``vcf --device cuda`` hands the runner a bare ``cuda`` (the mesh
    rule decides), ``cuda:N`` that card; the device is still checked
    before any output (stubbed here as present)."""
    from stoat_tpu_torch import device as tdevice
    from stoat_tpu_torch.pipeline import runner

    seen = []
    monkeypatch.setattr(tdevice, "resolve_device",
                        lambda name: torch.device(name))
    monkeypatch.setattr(runner, "run_vcf_analysis",
                        lambda *a, **k: seen.append(a[4]))
    p = data["paths"]
    for name in ("cuda", "cuda:1", "cpu"):
        assert torch_cli.main(["vcf", "-s", p["snarl"], "-v", p["vcf"], "-b",
                               p["binary"], "-o", str(tmp_path),
                               "--device", name]) == 0
    assert seen == [torch.device("cuda"), torch.device("cuda", 1), CPU]
