"""``simulate`` and ``truth`` in the port (``stoat_tpu_torch/simulate.py``)
against stoat_tpu's: every generated file byte for byte, and the truth
metrics of the port's ``vcf -b`` and ``vcf -q`` on those data.

Ports tests/test_simulate.py (test_simulate_and_recover_associations,
test_simulate_cli_and_truth_cli).
"""

import json
import os

import pytest

pytest.importorskip("torch")

from stoat_tpu import cli as jax_cli
from stoat_tpu import simulate as jax_simulate
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.simulate import generate_dataset, verify_truth


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_simulate_and_recover_associations(tmp_path):
    """tests/test_simulate.py:14 on the port."""
    out = str(tmp_path / "sim")
    files = generate_dataset(out, n_samples=150, n_snarls=60, seed=3,
                             effect_fraction=0.25, effect_shift=0.4)
    run_dir = str(tmp_path / "run")
    assert torch_cli.main(["vcf", "-s", files["snarl"], "-v", files["vcf"],
                           "-b", files["binary"], "-o", run_dir,
                           "--device", "cpu"]) == 0
    results = os.path.join(run_dir, "binary_table_vcf.tsv")
    metrics = verify_truth(results, files["truth"], p_threshold=1e-3,
                           freq_threshold=0.15)
    assert metrics["tp"] >= 3
    assert metrics["precision"] >= 0.7, metrics
    assert metrics["recall"] >= 0.5, metrics


def test_simulate_cli_and_truth_cli(tmp_path, capsys):
    """tests/test_simulate.py:31 on the port."""
    out = str(tmp_path / "sim2")
    assert torch_cli.main(["simulate", "-o", out, "-n", "60", "-s", "20",
                           "--seed", "5"]) == 0
    captured = capsys.readouterr().out
    files = dict(line.split("\t") for line in captured.strip().splitlines())
    assert os.path.exists(files["vcf"])
    assert os.path.exists(files["truth"])

    run_dir = str(tmp_path / "run2")
    assert torch_cli.main(["vcf", "-s", files["snarl"], "-v", files["vcf"],
                           "-q", files["quantitative"], "-o", run_dir,
                           "--device", "cpu"]) == 0
    assert torch_cli.main(["truth", "-r",
                           os.path.join(run_dir, "quantitative_table_vcf.tsv"),
                           "-f", files["truth"]]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) >= {"precision", "recall", "f1"}


TRIPLES = [(60, 20, 5, ()), (150, 60, 3, ("--effect-fraction", "0.25",
                                          "--effect-shift", "0.4")),
           (200, 100, 7, ()), (33, 7, 11, ("--effect-fraction", "1.0"))]


@pytest.mark.parametrize("n,s,seed,extra", TRIPLES)
def test_simulate_byte_identical(tmp_path, capsys, monkeypatch, n, s,
                                 seed, extra):
    """``simulate`` through both CLIs, each from its own directory with the
    same ``-o``: the same printed file list and every file byte for
    byte."""
    printed = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert cli.main(["simulate", "-o", "sim", "-n", str(n), "-s", str(s),
                         "--seed", str(seed), *extra]) == 0
        printed[name] = capsys.readouterr().out
    assert printed["torch"] == printed["jax"]
    assert printed["torch"].count("\n") == 6
    names = sorted(os.listdir(tmp_path / "jax" / "sim"))
    assert names == sorted(os.listdir(tmp_path / "torch" / "sim"))
    assert len(names) == 6
    for f in names:
        assert _read(tmp_path / "torch" / "sim" / f) == \
            _read(tmp_path / "jax" / "sim" / f), f


@pytest.mark.parametrize("n,s,seed,extra", TRIPLES[:3])
def test_truth_equal_on_port_tables(tmp_path, capsys, n, s, seed, extra):
    """``truth`` of the port's ``vcf -b`` and ``vcf -q`` tables on the
    simulated data prints the JSON that stoat_tpu prints on its own
    tables (which are byte-identical), at two thresholds; verify_truth
    equals stoat_tpu's on the port's tables."""
    files = generate_dataset(str(tmp_path / "sim"), n, s, seed)
    for flag, table in (("-b", "binary_table_vcf.tsv"),
                        ("-q", "quantitative_table_vcf.tsv")):
        pheno = files["binary" if flag == "-b" else "quantitative"]
        tsv = {}
        for name, cli, device in (("jax", jax_cli, ()),
                                  ("torch", torch_cli, ("--device", "cpu"))):
            out = str(tmp_path / f"{name}{flag}")
            assert cli.main(["vcf", "-s", files["snarl"], "-v",
                             files["vcf"], flag, pheno, "-o", out,
                             *device]) == 0
            tsv[name] = os.path.join(out, table)
        if flag == "-b":
            assert _read(tsv["torch"]) == _read(tsv["jax"])
        for thresholds in ((), ("-p", "0.001", "-t", "0.1")):
            lines = []
            for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
                assert cli.main(["truth", "-r", tsv[name], "-f",
                                 files["truth"], *thresholds]) == 0
                lines.append(capsys.readouterr().out)
            assert lines[0] == lines[1]
            assert json.loads(lines[1])["tp"] + json.loads(lines[1])["fn"] > 0
        assert verify_truth(tsv["torch"], files["truth"]) == \
            jax_simulate.verify_truth(tsv["torch"], files["truth"])
