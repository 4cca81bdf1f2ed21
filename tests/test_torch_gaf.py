"""``vcf -g`` in the port: the GAF files of a binary table
(``stoat_tpu_torch/gaf.py``) against stoat_tpu's on the same inputs.

Ports tests/test_gaf.py (the proportion's bounds, the star split, the
end-to-end run) and tests/test_cli_extras.py's
test_gaf_from_binary_container; the GAF files are held byte for byte for
GFA and .gbz graphs, the decomposition route and the dual ``-b -q``.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu import cli as jax_cli
from stoat_tpu import gaf as jax_gaf
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.gaf import _split_on_star, calcul_proportion_signi
from test_cli_decompose import build_fixture
from test_torch_cli import _chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAFS = ("binary_table_vcf_0.gaf", "binary_table_vcf_1.gaf")


@pytest.mark.parametrize("g0,g1,p", [
    (10, 20, 0.5), (0, 0, 0.5), (30, 0, 1e-10), (0, 30, 1e-10),
    (5, 5, 1.0), (100, 1, 1e-30),
])
def test_proportion_bounds(g0, g1, p):
    """tests/test_gaf.py:20, and the pair equals stoat_tpu's bit for
    bit."""
    a, b = calcul_proportion_signi(g0, g1, p)
    assert 0.0 <= a <= 60.0
    assert 0.0 <= b <= 60.0
    assert a + b <= 60.0 + 1e-9
    assert (a, b) == jax_gaf.calcul_proportion_signi(g0, g1, p)


def test_proportion_zero_total():
    assert calcul_proportion_signi(0, 0, 0.5) == (0.0, 0.0)


def test_split_on_star():
    assert [x[0] for x in _split_on_star(">1>2>4")] == [">1>2>4"]
    assert [x[0] for x in _split_on_star(">1>2>0>6>7")] == [">1>2", ">6>7"]
    # node ids containing the digit 0 are not stars
    assert [x[0] for x in _split_on_star(">10>20")] == [">10>20"]
    assert _split_on_star("<3>0<5") == jax_gaf._split_on_star("<3>0<5")


def test_gaf_end_to_end(tmp_path):
    """tests/test_gaf.py:38 on the port (case 2: the decomposition of -p
    -d, then the GWAS and the GAF files), byte for byte stoat_tpu's."""
    gfa, dist, vcf, pheno = build_fixture(tmp_path)
    outs = {}
    for name, cli, device in (("jax", jax_cli, ()),
                              ("torch", torch_cli, ("--device", "cpu"))):
        out = str(tmp_path / f"out_gaf_{name}")
        assert cli.main(["vcf", "-p", gfa, "-d", dist, "-v", vcf, "-b",
                         pheno, "-o", out, "-I", "2", "-H", "2", "-M",
                         "0.0", "-g", *device]) == 0
        outs[name] = out
    f0 = os.path.join(outs["torch"], GAFS[0])
    with open(f0) as fh:
        lines = [l.rstrip("\n").split("\t") for l in fh if l.strip()]
    assert lines, "GAF file should have rows"
    for name, path, length, prop in lines:
        assert "_G0_" in name
        assert path.startswith(">") or path.startswith("<")
        assert int(length) > 0
        assert 0.0 <= float(prop) <= 60.0
    for gaf in GAFS:
        assert _read(os.path.join(outs["torch"], gaf)) == \
            _read(os.path.join(outs["jax"], gaf))


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _cohort(tmp_path, n_snarls=60, n_chroms=2, seed=17):
    paths = make_fixture(str(tmp_path / "data"), n_samples=60,
                         n_snarls=n_snarls, seed=seed, n_chroms=n_chroms)
    graph = _chip_smoke().write_cohort_gfa(paths, str(tmp_path / "graph"),
                                           seed=seed)
    return paths, graph


def _gbz_of(gfa, out, package):
    """The GFA as a .gbz, written by ``package``'s save_gbz."""
    if package == "torch":
        from stoat_tpu_torch.graph.gbz_write import save_gbz
        from stoat_tpu_torch.graph.gfa import load_gfa
    else:
        from stoat_tpu.graph.gbz_write import save_gbz
        from stoat_tpu.graph.gfa import load_gfa
    save_gbz(load_gfa(gfa), out)
    return out


@pytest.mark.parametrize("graph_kind,pheno", [
    ("gfa", "b"), ("gbz", "b"), ("gfa", "bq"), ("gbz", "bq")])
def test_gaf_byte_identical(tmp_path, graph_kind, pheno):
    """``vcf -s -v -b [-q] -p GRAPH -g`` through both CLIs: the binary
    table and both GAF files byte for byte, for a GFA and a .gbz graph;
    the dual ``-b -q`` emits from its binary table.  The GAF lines'
    lengths are the graph's node lengths."""
    paths, graph = _cohort(tmp_path)
    gfa = graph["gfa"]
    if graph_kind == "gbz":
        gfa = _gbz_of(gfa, str(tmp_path / "graph.gbz"), "torch")
    extra = ["-q", paths["quantitative"]] if pheno == "bq" else []
    outs = {}
    for name, cli, device in (("jax", jax_cli, ()),
                              ("torch", torch_cli, ("--device", "cpu"))):
        out = str(tmp_path / name)
        assert cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                         "-b", paths["binary"], *extra, "-p", gfa, "-g",
                         "-o", out, *device]) == 0
        outs[name] = out
    names = GAFS + ("binary_table_vcf.tsv",) + (
        ("quantitative_table_vcf.tsv",) if pheno == "bq" else ())
    assert sorted(os.listdir(outs["torch"])) == sorted(
        os.listdir(outs["jax"]))
    for name in names:
        assert _read(os.path.join(outs["torch"], name)) == \
            _read(os.path.join(outs["jax"], name)), name
    data = _read(os.path.join(outs["torch"], GAFS[1])).decode()
    assert data.count("\n") > 60
    lengths = graph["lengths"]
    for line in data.splitlines():
        _, sub, length, _ = line.split("\t")
        ids = [int(n) for n in sub.replace("<", ">").split(">") if n]
        assert int(length) == sum(lengths[n] for n in ids)


def test_gaf_from_binary_container(tmp_path):
    """tests/test_cli_extras.py:199 on the port: ``-s -v -b -p x.gbz -g``
    through ``python -m stoat_tpu_torch`` in a subprocess, on the CPU; the
    GAF files equal stoat_tpu's run on the same .gbz (written by the
    port's save_gbz)."""
    from stoat_tpu_torch.graph.gbz_write import save_gbz
    from stoat_tpu_torch.graph.gfa import GfaGraph, GfaPath

    paths = make_fixture(str(tmp_path), n_samples=12, n_snarls=12,
                         seed=17, n_chroms=1)
    g = GfaGraph()
    max_node = 3 * 12 + 40
    for nid in range(1, max_node):
        g.add_node(nid, "ACG")
    g.add_path(GfaPath(name="ref", sample="ref", haplotype=0,
                       steps=[(1, False)], is_reference=True))
    gbz = tmp_path / "g.gbz"
    save_gbz(g, str(gbz))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    out = tmp_path / "gafout"
    rc = subprocess.run(
        [sys.executable, "-m", "stoat_tpu_torch", "vcf",
         "-s", paths["snarl"], "-v", paths["vcf"],
         "-b", paths["binary"], "-p", str(gbz), "-g",
         "-o", str(out), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path))
    assert rc.returncode == 0, rc.stderr[-800:]
    gafs = sorted(p.name for p in out.glob("*.gaf*"))
    assert gafs == list(GAFS), list(out.iterdir())
    jax_out = tmp_path / "jaxout"
    assert jax_cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                         "-b", paths["binary"], "-p", str(gbz), "-g",
                         "-o", str(jax_out)]) == 0
    for name in GAFS:
        assert (out / name).read_bytes() == (jax_out / name).read_bytes()


def test_gaf_with_covariates_warns_and_skips(tmp_path, capsys):
    """``-b -c -g``: both packages warn, write the table and no GAF."""
    paths, graph = _cohort(tmp_path, n_snarls=20, n_chroms=1)
    outs = {}
    for name, cli, device in (("jax", jax_cli, ()),
                              ("torch", torch_cli, ("--device", "cpu"))):
        out = str(tmp_path / name)
        capsys.readouterr()
        assert cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                         "-b", paths["binary"], "-c", paths["covariate"],
                         "-C", "AGE,SEX", "-p", graph["gfa"], "-g", "-o",
                         out, *device]) == 0
        warned = [line for line in capsys.readouterr().err.splitlines()
                  if line.startswith("[WARNING] -g/--gaf")]
        assert len(warned) == 1 and "binary_covar" in warned[0]
        outs[name] = sorted(os.listdir(out))
    assert outs["torch"] == outs["jax"]
    assert "binary_table_vcf.tsv" in outs["torch"]
    assert not [f for f in outs["torch"] if ".gaf" in f]


@pytest.mark.parametrize("case", ["no -p", "no -b", "-d without -p"])
def test_gaf_without_graph_or_binary_exits_1(tmp_path, case, capsys):
    """``-g`` needs ``-b`` and ``-p`` (stoat_tpu/cli.py:171-174): exit 1
    with stoat_tpu's message, in both packages, and no output."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=20, n_snarls=8,
                         seed=1)
    base = ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], "-g"]
    argv = {"no -p": base + ["-b", paths["binary"]],
            "no -b": base + ["-q", paths["quantitative"], "-p",
                             paths["snarl"]],
            "-d without -p": base + ["-b", paths["binary"], "-d",
                                     paths["snarl"]]}[case]
    messages = []
    for name, cli, device in (("jax", jax_cli, ()),
                              ("torch", torch_cli, ("--device", "cpu"))):
        out = tmp_path / name
        capsys.readouterr()
        assert cli.main(argv + ["-o", str(out), *device]) == 1
        assert not out.exists()
        messages.append([line for line in capsys.readouterr().err
                         .splitlines() if line.startswith("[ERROR]")])
    assert messages[0] == messages[1] and len(messages[0]) == 1
    assert "GAF file can be generated only" in messages[0][0]


def test_gaf_cuda_without_card_writes_nothing(tmp_path):
    """``vcf -g --device cuda`` without a card exits before any output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py runs -g there")
    paths, graph = _cohort(tmp_path, n_snarls=10, n_chroms=1)
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                        "-b", paths["binary"], "-p", graph["gfa"], "-g",
                        "-o", str(out), "--device", "cuda"])
    assert not out.exists()


def test_smoke_gaf_recomputation_matches_stoat_tpu(tmp_path):
    """chip_smoke.py's recomputation of GAF lines (phase 4's check of
    ``vcf -g`` on the card) agrees with stoat_tpu's GAF files, and finds a
    changed line."""
    smoke = _chip_smoke()
    paths, graph = _cohort(tmp_path, n_snarls=80)
    out = str(tmp_path / "jax")
    assert jax_cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                         "-b", paths["binary"], "-p", graph["gfa"], "-g",
                         "-o", out]) == 0
    tsv = os.path.join(out, "binary_table_vcf.tsv")
    gafs = [os.path.join(out, g) for g in GAFS]
    n = smoke.gaf_reference(tsv, paths["snarl"], graph["lengths"], *gafs,
                            n_rows=40)
    assert n > 80
    with open(gafs[1]) as fh:
        lines = fh.readlines()
    name, sub, length, prop = lines[5].rstrip("\n").split("\t")
    lines[5] = f"{name}\t{sub}\t{int(length) + 1}\t{prop}\n"
    with open(gafs[1], "w") as fh:
        fh.writelines(lines)
    with pytest.raises(smoke.SmokeFailure, match="GAF _1"):
        smoke.gaf_reference(tsv, paths["snarl"], graph["lengths"], *gafs,
                            n_rows=80)
