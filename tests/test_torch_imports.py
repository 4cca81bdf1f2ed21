"""Hygiene of the port: it never imports jax, triton or the JAX package
(``stoat_tpu``), it owns its native cores, and it never runs on the CPU
when a CUDA device was asked for.

The import checks run in a fresh interpreter, because this test process
has jax and stoat_tpu loaded for the parity tests.  Whether a CUDA card is
present is decided inside each test, never at import time.
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest
torch = pytest.importorskip("torch")

from stoat_tpu_torch import kernels
from stoat_tpu_torch.device import kernels_enabled, resolve_device
from stoat_tpu_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def _run(script: str, tmp_path) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, TESTS])
    return subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_runs_without_jax_or_triton(tmp_path):
    """Importing the port, its CLI, its runner, graph mode and every kernel
    module, and whole CPU runs of ``vcf -b``, ``vcf -b -c``, ``vcf -q``,
    ``vcf -q -c`` and the dual ``vcf -b -q`` (each alone and with
    ``--permutations 20``), of eQTL (``-e -G -c``), of the mixed model
    (``-q -k --lmm -c``), of ``-q -c -T 1.0`` (the regression tables), of
    the ``-p/-d`` decomposition route, alone (case 3) and with a GWAS, and
    of ``graph``, then importing chip_smoke.py, leave jax, jaxlib, triton and
    every stoat_tpu module out of sys.modules and need no CUDA toolkit (no
    kernel is built).  The decomposition inputs are written here: the
    module that writes them imports stoat_tpu."""
    from test_cli_decompose import build_fixture
    deco = tmp_path / "deco"
    deco.mkdir()
    gfa, dist, dvcf, dpheno = build_fixture(deco)
    res = _run(f"""
        import os, sys
        import stoat_tpu_torch
        import stoat_tpu_torch.cli
        import stoat_tpu_torch.graph
        import stoat_tpu_torch.pipeline.permutation
        import stoat_tpu_torch.pipeline.runner
        import stoat_tpu_torch.pipeline.quantitative
        import stoat_tpu_torch.stats.linalg
        import stoat_tpu_torch.stats.linreg
        import stoat_tpu_torch.stats.lmm
        import stoat_tpu_torch.stats.logreg
        import stoat_tpu_torch.stats.special
        from stoat_tpu_torch.kernels import build
        from fixtures import make_fixture
        p = make_fixture({str(tmp_path / 'data')!r}, n_samples=20,
                         n_snarls=12, seed=4)
        out = {str(tmp_path / 'out')!r}
        covar = ["-c", p["covariate"], "-C", "AGE,SEX"]
        kin = os.path.join({str(tmp_path)!r}, "kinship.tsv")
        with open(kin, "w") as fh:
            fh.write("id\\t" + "\\t".join(p["samples"]) + "\\n")
            for i, s in enumerate(p["samples"]):
                fh.write(s + "\\t" + "\\t".join(
                    "1" if j == i else "0.1" for j in range(20)) + "\\n")
        both = ["-b", p["binary"], "-q", p["quantitative"]]
        runs = ((["-b", p["binary"]], ["binary"]),
                (["-b", p["binary"], *covar], ["binary"]),
                (["-q", p["quantitative"]], ["quantitative"]),
                (["-q", p["quantitative"], *covar], ["quantitative"]),
                (both, ["binary", "quantitative"]))
        for perms in ([], ["--permutations", "20", "--perm-seed", "3"]):
            for pheno, tables in runs:
                rc = stoat_tpu_torch.cli.main(
                    ["vcf", "-s", p["snarl"], "-v", p["vcf"], *pheno,
                     "-o", out, "--device", "cpu", *perms])
                assert rc == 0, rc
                names = [t + "_table_vcf.tsv" for t in tables]
                if perms:
                    names += [t + "_permutation_vcf.tsv" for t in tables]
                for name in names:
                    with open(os.path.join(out, name)) as fh:
                        assert fh.readline().startswith("#CHR")
                        assert fh.readline()
                    os.remove(os.path.join(out, name))
        for pheno, name in (
                (["-e", p["qtl"], "-G", p["gene_position"], *covar],
                 "eqtl_table_vcf.tsv"),
                (["-q", p["quantitative"], "-k", kin, "--lmm", *covar],
                 "lmm_table_vcf.tsv")):
            rc = stoat_tpu_torch.cli.main(
                ["vcf", "-s", p["snarl"], "-v", p["vcf"], *pheno, "-o", out,
                 "--device", "cpu"])
            assert rc == 0, rc
            with open(os.path.join(out, name)) as fh:
                assert fh.readline().startswith("#CHR")
                assert fh.readline()
        rc = stoat_tpu_torch.cli.main(
            ["vcf", "-s", p["snarl"], "-v", p["vcf"], "-q", p["quantitative"],
             *covar, "-T", "1.0", "-o", out, "--device", "cpu"])
        assert rc == 0, rc
        assert os.listdir(os.path.join(out, "regression"))
        rc = stoat_tpu_torch.cli.main(
            ["vcf", "-p", {gfa!r}, "-d", {dist!r}, "-v", {dvcf!r}, "-b",
             {dpheno!r}, "-o", out, "--device", "cpu"])
        assert rc == 0, rc
        with open(os.path.join(out, "binary_table_vcf.tsv")) as fh:
            assert len(fh.readlines()) > 1
        case3 = os.path.join(out, "case3")
        rc = stoat_tpu_torch.cli.main(["vcf", "-p", {gfa!r}, "-d", {dist!r},
                                       "-o", case3])
        assert rc == 0, rc
        assert sorted(os.listdir(case3)) == ["snarl_analyse.tsv",
                                             "snarl_not_analyse.tsv"]
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join({REPO!r}, "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        g = smoke.write_graph({str(tmp_path / 'graph')!r}, 30, 8)
        rc = stoat_tpu_torch.cli.main(
            ["graph", "-p", g["gfa"], "-d", g["gfa"], "-b", g["pheno"],
             "-r", "ref", "-V", "0", "-o", out, "--device", "cpu"])
        assert rc == 0, rc
        with open(os.path.join(out, "binary_table_graph.tsv")) as fh:
            assert len(fh.readlines()) > 20
        assert not build.BUILD_LOG, build.BUILD_LOG
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "triton",
                                            "stoat_tpu"))
        assert not bad, bad
        print("OK")
    """, tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_port_never_imports_stoat_tpu():
    """No module of the port, not chip_smoke.py and no script under
    tools/ names the JAX package in an import statement (stoat_tpu_torch
    is the port itself)."""
    files = sorted(glob.glob(os.path.join(REPO, "stoat_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    files += sorted(glob.glob(os.path.join(REPO, "tools", "*.py")))
    assert len(files) > 30
    found = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                      for n in names if n.split(".")[0] == "stoat_tpu"]
    assert not found, found


def test_native_libraries_build_under_the_build_dir():
    """The port's native cores load from build/stoat_tpu_torch/native/,
    under a name keyed by the source, the flags and the host CPU."""
    from stoat_tpu_torch import native
    build_dir = os.path.join(REPO, "build", "stoat_tpu_torch", "native")
    assert native.BUILD_DIR == build_dir
    for src, libs, get in ((native._SRC, native._CORE_LIBS, native.get_lib),
                           (native._GRAPH_SRC, (), native.get_graph_lib)):
        assert os.path.dirname(src) == os.path.join(REPO, "stoat_tpu_torch",
                                                    "native")
        path = native.library_path(src, libs)
        assert os.path.dirname(path) == build_dir
        lib = get()
        assert lib is not None and os.path.samefile(lib._name, path)
    assert "-march=native" in native.CXX_FLAGS


def test_native_key_change_forces_rebuild(monkeypatch):
    """A library built for another host (another key) is never loaded:
    with the key changed, the core is built again, under the new name."""
    from stoat_tpu_torch import native
    before = native.library_path(native._SRC, native._CORE_LIBS)
    built = []

    def fake_compile(src, lib, extra=()):
        built.append((src, lib))
        return False                      # nothing is written

    monkeypatch.setattr(native, "host_key", lambda: "another host")
    monkeypatch.setattr(native, "_compile", fake_compile)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    after = native.library_path(native._SRC, native._CORE_LIBS)
    assert after != before and os.path.dirname(after) == native.BUILD_DIR
    assert native.get_lib() is None
    assert built == [(native._SRC, after)]


def test_cuda_device_never_falls_back_to_cpu(tmp_path):
    """``--device cuda`` with no card is an error; with a card it is the
    card.  Decided here, at run time."""
    res = _run("""
        import torch
        from stoat_tpu_torch.device import resolve_device
        if torch.cuda.is_available():
            assert resolve_device("cuda").type == "cuda"
        else:
            try:
                dev = resolve_device("cuda")
            except RuntimeError as e:
                assert "no CUDA device" in str(e)
            else:
                raise AssertionError(f"ran on {dev}")
        print("OK")
    """, tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "OK"


def test_cuda_cli_without_card_exits_before_any_output(tmp_path):
    """The CLI resolves the device before it writes anything."""
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    from fixtures import make_fixture
    from stoat_tpu_torch import cli

    p = make_fixture(str(tmp_path / "data"), n_samples=20, n_snarls=8,
                     seed=1)
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["vcf", "-s", p["snarl"], "-v", p["vcf"], "-b",
                  p["binary"], "-o", str(out), "--device", "cuda"])
    assert not out.exists()


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    assert not kernels_enabled("cpu")
    assert kernels_enabled("cuda:0")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_build_needs_nvcc():
    """Without nvcc the build raises a clear error instead of loading
    anything; with it, nvcc is found."""
    try:
        path = build.find_nvcc()
    except RuntimeError as e:
        assert "nvcc not found" in str(e)
    else:
        assert os.path.isfile(path)
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_check_tensor_rejects_what_a_kernel_cannot_take():
    cpu = torch.device("cpu")
    t = torch.zeros(4, 3, dtype=torch.int32)
    kernels.check_tensor(t, "t", torch.int32, (4, 3), cpu)
    with pytest.raises(ValueError, match="dtype"):
        kernels.check_tensor(t, "t", torch.int64, (4, 3), cpu)
    with pytest.raises(ValueError, match="shape"):
        kernels.check_tensor(t, "t", torch.int32, (3, 4), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.check_tensor(t.t(), "t", torch.int32, (3, 4), cpu)
    with pytest.raises(ValueError, match="expected meta"):
        kernels.check_tensor(t, "t", torch.int32, (4, 3),
                             torch.device("meta"))


def test_launch_counts_reset():
    kernels.LAUNCHES["fisher"] += 3
    kernels.reset_launch_counts()
    assert set(kernels.LAUNCHES) == {"membership_counts", "binary_tables",
                                     "fisher", "quant_design", "ols",
                                     "student_t", "graph_stats", "logreg",
                                     "perm_membership", "perm_binary",
                                     "perm_ols", "score_precompute",
                                     "score_perm", "eqtl_ols", "chi2_tail"}
    assert all(v == 0 for v in kernels.LAUNCHES.values())
