"""eQTL on the snarl mesh: ``run_vcf_analysis(mode="eqtl")`` on a mesh of
CPU devices named several times, each chunk's design, pairs and OLS on
its own device, against stoat_tpu's runner on conftest.py's 8 virtual
devices (its sharded run), byte for byte.  The fixtures and seeds are
tests/test_eqtl_sharded.py's (40 samples, 16 snarls, no covariates);
genes every 400 bp with a 300 bp window leave some snarls without a gene
and give others several.
"""

import filecmp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu.io.phenotype import QtlData as JQtl
from stoat_tpu.io.snarl_file import parse_snarl_path as j_snarls
from stoat_tpu.pipeline.runner import run_vcf_analysis as j_run
from stoat_tpu_torch.io.phenotype import QtlData
from stoat_tpu_torch.io.snarl_file import parse_snarl_path
from stoat_tpu_torch.parallel import make_snarl_mesh
from stoat_tpu_torch.pipeline.runner import run_vcf_analysis

CPU = torch.device("cpu")
N_SAMPLES, N_SNARLS, WINDOW = 40, 16, 300


@pytest.mark.parametrize("seed,n", [(19, 8), (19, 3), (23, 1), (23, 3),
                                    (23, 8), (23, 40)])
def test_eqtl_mesh_parity(tmp_path, seed, n):
    """vcf -e on a mesh of n at chunks of ceil(16 / n) snarls: every row
    of stoat_tpu's sharded run, byte for byte; 40 devices leave some
    idle."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=N_SAMPLES,
                         n_snarls=N_SNARLS, seed=seed)
    rng = np.random.default_rng(seed)
    genes = [(f"gene{i}", rng.standard_normal(N_SAMPLES), 100 + 400 * i,
              300 + 400 * i) for i in range(6)]
    samples = list(paths["samples"])
    got, want = str(tmp_path / "port.tsv"), str(tmp_path / "jax.tsv")
    run_vcf_analysis(paths["vcf"], parse_snarl_path(paths["snarl"]), got,
                     {"ref": [QtlData(*g) for g in genes]}, CPU,
                     mode="eqtl", windows_gene_threshold=WINDOW,
                     sample_names=samples,
                     snarl_chunk_size=-(-N_SNARLS // n),
                     mesh=make_snarl_mesh([CPU] * n))
    j_run(paths["vcf"], j_snarls(paths["snarl"]), want, "eqtl",
          eqtl_map={"ref": [JQtl(*g) for g in genes]},
          windows_gene_threshold=WINDOW, sample_names=samples)
    with open(want) as fh:
        rows = fh.read().splitlines()[1:]
    assert rows and len({r.split("\t")[3] for r in rows}) > 1
    assert filecmp.cmp(got, want, shallow=False)
