"""Hygiene of the port: it never imports jax (or triton), and it never runs
on the CPU when a CUDA device was asked for.

The import checks run in a fresh interpreter, because this test process
has jax loaded for the parity tests.  Whether a CUDA card is present is
decided inside each test, never at import time.
"""

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
    module, and whole CPU runs of ``vcf -b``, ``vcf -b -c``, ``vcf -q -c``
    and ``graph``, leave jax and triton out of sys.modules and need no
    CUDA toolkit (nothing is built)."""
    res = _run(f"""
        import os, sys
        import stoat_tpu_torch
        import stoat_tpu_torch.cli
        import stoat_tpu_torch.graph
        import stoat_tpu_torch.pipeline.runner
        import stoat_tpu_torch.pipeline.quantitative
        import stoat_tpu_torch.stats.linalg
        import stoat_tpu_torch.stats.linreg
        import stoat_tpu_torch.stats.logreg
        import stoat_tpu_torch.stats.special
        from stoat_tpu_torch.kernels import build
        from fixtures import make_fixture
        p = make_fixture({str(tmp_path / 'data')!r}, n_samples=20,
                         n_snarls=12, seed=4)
        out = {str(tmp_path / 'out')!r}
        covar = ["-c", p["covariate"], "-C", "AGE,SEX"]
        for pheno, table in ((["-b", p["binary"]], "binary"),
                             (["-b", p["binary"], *covar], "binary"),
                             (["-q", p["quantitative"], *covar],
                              "quantitative")):
            rc = stoat_tpu_torch.cli.main(
                ["vcf", "-s", p["snarl"], "-v", p["vcf"], *pheno,
                 "-o", out, "--device", "cpu"])
            assert rc == 0, rc
            with open(os.path.join(out, table + "_table_vcf.tsv")) as fh:
                assert fh.readline().startswith("#CHR")
                assert fh.readline()
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
                     if m.split(".")[0] in ("jax", "jaxlib", "triton"))
        assert not bad, bad
        print("OK")
    """, tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


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
                                     "student_t", "graph_stats", "logreg"}
    assert all(v == 0 for v in kernels.LAUNCHES.values())
