"""Directory-level system-test replay on self-generated data, on the port.

The JAX suite's tests (tests/test_system_replay.py) replay the frozen
goldens of ``tests/golden_sysdir/`` through the CLI: the four modes the
reference commits goldens for (binary, binary_covar, quantitative,
quantitative_covar) on the seeded simulator's dataset, and eQTL on a
``make_fixture`` cohort.  Here the port's CLI runs them on the CPU, on a
dataset from the port's own simulator, and must match the same goldens
keyed by SNARL (SNARL+GENE for eQTL) with exact line equality; its
output directory is also byte for byte ``stoat_tpu``'s
(``test_torch_end_to_end.cli_main``).  The goldens are the JAX suite's:
they are only read here, and a regeneration run skips these tests.
"""

import os

import pytest

pytest.importorskip("torch")

from test_system_replay import (GOLDEN_DIR, MODES, N_SAMPLES, N_SNARLS,
                                SEED, assert_dir_matches_golden)
from test_torch_end_to_end import cli_main

REGEN = os.environ.get("STOAT_REGEN_GOLDEN") == "1"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from stoat_tpu_torch.simulate import generate_dataset
    tmp = tmp_path_factory.mktemp("sysreplay")
    files = generate_dataset(str(tmp / "data"), n_samples=N_SAMPLES,
                             n_snarls=N_SNARLS, seed=SEED)
    return files, tmp


@pytest.mark.skipif(REGEN, reason="goldens are being regenerated")
def test_directory_replay_eqtl(tmp_path):
    from fixtures import make_fixture

    files = make_fixture(str(tmp_path), n_samples=40, n_snarls=60,
                         seed=SEED)
    out = tmp_path / "out_eqtl"
    rc = cli_main(["vcf", "-s", files["snarl"], "-v", files["vcf"],
                   "-e", files["qtl"], "-G", files["gene_position"],
                   "-o", str(out)])
    assert rc == 0
    # key = (SNARL, GENE) per compare_files_utils.cpp:27-59
    assert_dir_matches_golden(str(out), os.path.join(GOLDEN_DIR, "eqtl"),
                              key_cols=(3, 5))


@pytest.mark.skipif(REGEN, reason="goldens are being regenerated")
@pytest.mark.parametrize("mode", sorted(MODES))
def test_directory_replay(dataset, mode):
    files, tmp = dataset
    flags, out_name = MODES[mode]
    out = tmp / f"out_{mode}"
    args = ["vcf", "-s", files["snarl"], "-v", files["vcf"],
            "-o", str(out)]
    for f in flags:
        args += [f, {"-b": files["binary"], "-q": files["quantitative"],
                     "-c": files["covariate"]}[f]]
        if f == "-c":
            args += ["--covar-name", "PC1,PC2"]
    rc = cli_main(args)
    assert rc == 0
    assert (out / out_name).exists()
    assert_dir_matches_golden(str(out), os.path.join(GOLDEN_DIR, mode))
