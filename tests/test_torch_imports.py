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
import re
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


# a script's first lines: jax, jaxlib, triton and stoat_tpu cannot be
# imported (indented as the scripts below, which _run dedents)
BLOCK = """
        import sys
        class _Blocked:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "triton",
                                          "stoat_tpu"):
                    raise ImportError(f"{name} is blocked here")
                return None
        sys.meta_path.insert(0, _Blocked())
"""


def test_port_runs_without_jax_or_triton(tmp_path):
    """With jax, jaxlib, triton and stoat_tpu blocked from importing:
    importing the port, its CLI, its runner, graph mode and every kernel
    module, and whole CPU runs of ``vcf -b``, ``vcf -b -c``, ``vcf -q``,
    ``vcf -q -c`` and the dual ``vcf -b -q`` (each alone and with
    ``--permutations 20``), of eQTL (``-e -G -c``), of the mixed model
    (``-q -k --lmm -c``), of ``-q -c -T 1.0`` (the regression tables), of
    the ``-p/-d`` decomposition route, alone (case 3) and with a GWAS, and
    of ``graph``, then importing chip_smoke.py, then ``vcf -b -p GFA -g``,
    ``BHcorrect``, ``simulate`` and ``truth``, and the runner and the
    permutation pass on a mesh of two CPU devices (parallel/), leave jax,
    jaxlib, triton and
    every stoat_tpu module out of sys.modules and need no CUDA toolkit (no
    kernel is built).  The decomposition inputs are written here: the
    module that writes them imports stoat_tpu."""
    from test_cli_decompose import build_fixture
    deco = tmp_path / "deco"
    deco.mkdir()
    gfa, dist, dvcf, dpheno = build_fixture(deco)
    res = _run(BLOCK + f"""
        import os, sys
        import stoat_tpu_torch
        import stoat_tpu_torch.cli
        import stoat_tpu_torch.graph
        import stoat_tpu_torch.parallel
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
        cohort = smoke.write_cohort_gfa(p, {str(tmp_path / 'cohort')!r})
        gout = os.path.join(out, "gaf")
        rc = stoat_tpu_torch.cli.main(
            ["vcf", "-s", p["snarl"], "-v", p["vcf"], "-b", p["binary"],
             "-p", cohort["gfa"], "-g", "-o", gout, "--device", "cpu"])
        assert rc == 0, rc
        for g in (0, 1):
            with open(os.path.join(gout, f"binary_table_vcf_{{g}}.gaf")) as fh:
                assert len(fh.readlines()) > 12
        rc = stoat_tpu_torch.cli.main(
            ["BHcorrect", "-t", os.path.join(gout, "binary_table_vcf.tsv"),
             "-p", "7", "-a", "8", "-o", gout])
        assert rc == 0, rc
        assert os.path.exists(os.path.join(gout, "top_variant.tsv"))
        sim = os.path.join(out, "sim")
        rc = stoat_tpu_torch.cli.main(["simulate", "-o", sim, "-n", "30",
                                       "-s", "10"])
        assert rc == 0, rc
        rc = stoat_tpu_torch.cli.main(
            ["truth", "-r", os.path.join(gout, "binary_table_vcf.tsv"), "-f",
             os.path.join(sim, "snarls.freq.tsv")])
        assert rc == 0, rc
        import torch
        from stoat_tpu_torch.io import parse_binary_pheno, parse_snarl_path
        from stoat_tpu_torch.pipeline.permutation import run_permutation_test
        from stoat_tpu_torch.pipeline.runner import run_vcf_analysis
        mesh = stoat_tpu_torch.parallel.make_snarl_mesh(["cpu"] * 2)
        pheno, samples = parse_binary_pheno(p["binary"], list(p["samples"]))
        snarls_chr = parse_snarl_path(p["snarl"])
        run_vcf_analysis(p["vcf"], snarls_chr, os.path.join(out, "m.tsv"),
                         pheno, torch.device("cpu"), sample_names=samples,
                         mesh=mesh)
        assert run_permutation_test(p["vcf"], snarls_chr,
                                    os.path.join(out, "mp.tsv"),
                                    pheno_bin=pheno, n_perms=5, mesh=mesh) > 0
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
    """No module of the port (its mesh, parallel/, included), not
    chip_smoke.py and no script under tools/ names the JAX package, jax or
    jaxlib in an import statement (stoat_tpu_torch is the port itself)."""
    files = sorted(glob.glob(os.path.join(REPO, "stoat_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    files += sorted(glob.glob(os.path.join(REPO, "tools", "*.py")))
    assert len(files) > 30
    assert {os.path.join(REPO, "stoat_tpu_torch", "parallel", f"{name}.py")
            for name in ("__init__", "mesh", "sharded")} <= set(files)
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
                      for n in names
                      if n.split(".")[0] in ("stoat_tpu", "jax", "jaxlib")]
    assert not found, found


def test_kernel_attributes_are_not_kept_per_process():
    """The CUDA runtime keeps a function's attributes and occupancy for
    each device apart, so no source keeps the result of
    cudaFuncSetAttribute, or a resident-block count, in a ``static``: one
    stored at the first launch would hold for that card only, and a
    launch on a second card of a mesh would run without it."""
    sources = sorted(glob.glob(os.path.join(REPO, "stoat_tpu_torch", "csrc",
                                            "*.cu"))
                     + glob.glob(os.path.join(REPO, "stoat_tpu_torch",
                                              "csrc", "*.cuh")))
    assert len(sources) > 15
    kept = re.compile(r"\bstatic\b[^;{}]*?=\s*(cudaFuncSetAttribute|"
                      r"resident_blocks)\s*\(")
    found, calls = [], 0
    for path in sources:
        with open(path) as fh:
            text = fh.read()
        calls += text.count("cudaFuncSetAttribute(")
        found += [f"{os.path.basename(path)}: {m.group(0)!r}"
                  for m in kept.finditer(text)]
    assert calls >= 6
    assert not found, found


def test_host_commands_leave_torch_and_matplotlib_out(tmp_path):
    """``import stoat_tpu_torch`` and its CLI, then ``simulate``, ``truth``
    and ``BHcorrect`` import neither torch nor matplotlib (they are host
    work, as in stoat_tpu); ``vcf -b -g`` then imports torch and still not
    matplotlib; ``plot`` is the one command that imports it."""
    res = _run(BLOCK + f"""
        import os, sys
        import stoat_tpu_torch
        from stoat_tpu_torch import cli
        out = {str(tmp_path / 'out')!r}
        assert cli.main(["simulate", "-o", out, "-n", "40", "-s", "12"]) == 0
        # a binary results table of the simulated snarls, written here
        tsv = os.path.join(out, "results.tsv")
        with open(os.path.join(out, "snarl_analyse.tsv")) as fh, \\
                open(tsv, "w") as res:
            fh.readline()
            res.write("#CHR\\tSTART_POS\\tEND_POS\\tSNARL\\tPATH_LENGTHS\\t"
                      "P_FISHER\\tP_CHI2\\tGROUP_PATHS\\tDEPTH\\n")
            for i, line in enumerate(fh):
                c = line.split("\\t")
                res.write(f"{{c[0]}}\\t{{c[1]}}\\t{{c[2]}}\\t{{c[4]}}\\t1,1\\t"
                          f"0.5\\t{{10.0 ** -i:.4g}}\\t3:4,5:6\\t1\\n")
        assert cli.main(["truth", "-r", tsv, "-f",
                         os.path.join(out, "snarls.freq.tsv")]) == 0
        assert cli.main(["BHcorrect", "-t", tsv, "-p", "7", "-a", "8", "-o",
                         out]) == 0
        with open(os.path.join(out, "top_variant.tsv")) as fh:
            assert len(fh.readlines()) > 3
        assert "torch" not in sys.modules
        assert "matplotlib" not in sys.modules
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join({REPO!r}, "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        from fixtures import make_fixture
        p = make_fixture(os.path.join(out, "data"), n_samples=20,
                         n_snarls=12, seed=4)
        g = smoke.write_cohort_gfa(p, os.path.join(out, "graph"))
        assert cli.main(["vcf", "-s", p["snarl"], "-v", p["vcf"], "-b",
                         p["binary"], "-p", g["gfa"], "-g", "-o",
                         os.path.join(out, "run"), "--device", "cpu"]) == 0
        assert "torch" in sys.modules
        assert "matplotlib" not in sys.modules
        if importlib.util.find_spec("matplotlib") is not None:
            assert cli.main(["plot", "qq", "-t", os.path.join(
                out, "run", "binary_table_vcf.tsv"), "-o",
                os.path.join(out, "qq.png")]) == 0
            assert "matplotlib" in sys.modules
        print("OK")
    """, tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_matplotlib_only_inside_the_plot_functions():
    """No module of the port, not chip_smoke.py and no script under tools/
    imports matplotlib, but the plotting functions of
    stoat_tpu_torch/plots.py, each inside its own body."""
    files = sorted(glob.glob(os.path.join(REPO, "stoat_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    files += sorted(glob.glob(os.path.join(REPO, "tools", "*.py")))
    plots = os.path.join(REPO, "stoat_tpu_torch", "plots.py")
    assert plots in files
    found = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for func in [None] + [n for n in ast.walk(tree)
                              if isinstance(n, ast.FunctionDef)]:
            body = tree.body if func is None else func.body
            for node in (n for stmt in body for n in ast.walk(stmt)):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                if any(n.split(".")[0] == "matplotlib" for n in names):
                    found.append((os.path.relpath(path, REPO),
                                  func and func.name, node.lineno))
    inside = {(f, name) for f, name, _ in found if name}
    assert inside == {("stoat_tpu_torch/plots.py", name) for name in (
        "qq_plot", "manhattan_plot", "snarl_boxplots", "histogram_plot",
        "scatter_plot", "report_plots")}, found
    # every import sits in a function (ast.walk of the module reaches the
    # same nodes through the functions)
    by_line = {}
    for f, name, line in found:
        by_line.setdefault((f, line), set()).add(name)
    assert all(names - {None} for names in by_line.values()), found


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
                                     "binary_stats", "binary_from_words",
                                     "fisher",
                                     "quant_design", "ols",
                                     "student_t", "graph_stats", "logreg",
                                     "perm_membership", "perm_binary",
                                     "perm_ols", "score_precompute",
                                     "score_perm", "eqtl_ols", "chi2_tail"}
    assert all(v == 0 for v in kernels.LAUNCHES.values())
