"""The command's contract: its last line, its refusal without a card, the
modules it may not load, and its run on the card."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from gwasbench.tests.gwasbench_tiny import CELLS, run_tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_has_the_contract_keys_and_checks_last():
    res = run_tiny(CELLS[0])
    assert all(k in res for k in KEYS)
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"snarl_tests_per_s", "setup_s"}
    assert res["metrics"]["snarl_tests_per_s"]["value"] > 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_traced_result_reads_the_spans():
    res = run_tiny(CELLS[0], trace=True)
    got = set(res["metrics"])
    assert {"runner_s_per_job", "perm_pass_s_per_job",
            "ingest_s_per_job"} <= got
    assert "snarl_tests_per_s" not in got
    assert res["breakdown"]["idle_gaps"]


def test_command_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "gwasbench/run.py", "--workload", CELLS[0],
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout


GUARD = textwrap.dedent("""
    import sys
    BLOCKED = {"jax", "jaxlib", "flax", "stoat_tpu", "bench", "chip_smoke"}
    tried = []

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                tried.append(name)
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, ROOT)
    from gwasbench.tests.gwasbench_tiny import run_tiny
    res = run_tiny(CELL, trace=True)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print("TRIED", tried, "LOADED", loaded, "CORRECT", res["correct"])
    sys.exit(1 if tried or loaded or not res["correct"] else 0)
""")


@pytest.mark.parametrize("name", CELLS)
def test_no_module_of_jax_or_the_jax_package_is_imported(name):
    code = f"ROOT = {ROOT!r}\nCELL = {name!r}\n" + GUARD
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    res = subprocess.run(
        [sys.executable, "gwasbench/run.py", "--workload", name,
         "--seed", "3000000002", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


@pytest.mark.parametrize("chips,want", [(1, "cuda:0"), (4, "cuda")])
def test_the_device_follows_the_cells_chips(chips, want):
    from dataclasses import replace
    from gwasbench import harness
    cell = replace(harness.load_cell(CELLS[0]), chips=chips)
    assert harness.cell_device(cell) == want
