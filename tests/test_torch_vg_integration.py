"""vg-in-the-loop integration on the port: real vg-produced artifacts
through the port's decomposition, ``vcf`` runner and ``graph``.

The JAX suite's tests (tests/test_vg_integration.py) with its dataset
(``vg construct``, ``vg index``/``vg gbwt``, ``vg deconstruct``: its
``vg_dataset`` fixture), run on the port on the CPU; each output is also
byte for byte ``stoat_tpu``'s.  They skip as the JAX suite's do: all of
them unless a ``vg`` executable is on PATH, the reference-binary diff
also unless ``STOAT_BIN`` points at a built reference ``stoat``.
"""

import filecmp

import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.graph.decompose import \
    decompose_to_snarl_file as jax_decompose_to_snarl_file
from stoat_tpu.pipeline.runner import run_vcf_analysis as jax_run
from stoat_tpu_torch.graph.decompose import decompose_to_snarl_file
from stoat_tpu_torch.io.phenotype import parse_binary_pheno
from stoat_tpu_torch.pipeline.runner import run_vcf_analysis

from test_torch_graph_association import run_graph_association
from test_vg_integration import (STOAT_BIN, VG, _read_keyed, _run,
                                 vg_dataset)  # noqa: F401 (fixture)

pytestmark = pytest.mark.skipif(VG is None, reason="vg binary not on "
                                "PATH (run inside the Docker image)")

CPU = torch.device("cpu")


def _decompose(graph, dist, out):
    """The port's decomposition into ``out``; stoat_tpu's writes the same
    files into a twin directory."""
    snarls = decompose_to_snarl_file(graph, dist, str(out), {"chr1"})
    twin = out.parent / f"{out.name}_stoat_tpu"
    jax_decompose_to_snarl_file(graph, dist, str(twin), {"chr1"})
    for name in ("snarl_analyse.tsv", "snarl_not_analyse.tsv"):
        assert filecmp.cmp(out / name, twin / name, shallow=False), name
    return snarls


def _binary_table(d, snarls, out_tsv):
    """The port's binary run on the CPU, byte for byte stoat_tpu's."""
    pheno, samples = parse_binary_pheno(str(d["pheno"]), [])
    run_vcf_analysis(str(d["at_vcf"]), snarls, str(out_tsv), pheno, CPU,
                     sample_names=samples)
    twin = out_tsv.parent / f"stoat_tpu_{out_tsv.name}"
    jax_run(str(d["at_vcf"]), snarls, str(twin), "binary",
            binary_phenotype=pheno, sample_names=samples, use_mesh=False)
    assert filecmp.cmp(out_tsv, twin, shallow=False)


def test_vg_gfa_decomposition_and_gwas(vg_dataset):
    """vg-produced GFA + deconstruct VCF through decomposition + binary
    GWAS: rows come out, p-values parse, and the GFA/GBZ containers of
    the SAME graph yield identical decompositions (keyed)."""
    d = vg_dataset
    out_gfa = d["tmp"] / "torch_out_gfa"
    out_gbz = d["tmp"] / "torch_out_gbz"
    snarls = _decompose(str(d["gfa"]), str(d["dist"]), out_gfa)
    assert sum(len(v) for v in snarls.values()) >= 15
    _decompose(str(d["gbz"]), str(d["dist"]), out_gbz)
    _h1, r1 = _read_keyed(out_gfa / "snarl_analyse.tsv", key_col=4)
    _h2, r2 = _read_keyed(out_gbz / "snarl_analyse.tsv", key_col=4)
    assert set(r1) == set(r2), "GFA vs GBZ decomposition keys differ"

    out_tsv = d["tmp"] / "torch_binary_table_vcf.tsv"
    _binary_table(d, snarls, out_tsv)
    _h, rows = _read_keyed(out_tsv)
    tested = [c for c in rows.values() if c[6] != "NA"]
    assert len(tested) >= 10
    for c in tested:
        assert 0.0 <= float(c[6]) <= 1.0


def test_vg_graph_mode_runs(vg_dataset):
    """`stoat graph` on the vg-built GBZ (haplotype paths from the
    GBWT): the native prepare partitions real vg sample paths."""
    d = vg_dataset
    out = d["tmp"] / "torch_graph_out"
    out.mkdir(exist_ok=True)
    rc = run_graph_association(str(d["gbz"]), str(d["dist"]),
                               str(d["pheno"]), "chi2", "tsv", 0,
                               "chr1", str(out))
    assert rc == 0
    with open(out / "binary_table_graph.tsv") as fh:
        assert len(fh.readlines()) >= 10


@pytest.mark.skipif(STOAT_BIN is None,
                    reason="STOAT_BIN not set (no reference build)")
def test_reference_binary_diff(vg_dataset):
    """Reference stoat vs the port on IDENTICAL vg-built inputs:
    decomposition keys must match (orientation-insensitive) and the
    binary GWAS tables must agree row-for-row on the keyed comparison
    (the reference's own system-test semantics,
    tests/system/compare_files_utils.cpp:226-252)."""
    d = vg_dataset
    ref_out = d["tmp"] / "ref_out"
    ref_out.mkdir(exist_ok=True)
    _run([STOAT_BIN, "vcf", "-p", str(d["vg"]), "-d", str(d["dist"]),
          "-v", str(d["at_vcf"]), "-b", str(d["pheno"]),
          "-o", str(ref_out), "-r", "chr1"])
    our_out = d["tmp"] / "torch_our_out"
    snarls = _decompose(str(d["gfa"]), str(d["dist"]), our_out)
    _h, ref_dec = _read_keyed(ref_out / "snarl_analyse.tsv", key_col=4)
    _h, our_dec = _read_keyed(our_out / "snarl_analyse.tsv", key_col=4)
    assert set(ref_dec) == set(our_dec)

    ours = d["tmp"] / "torch_our_binary.tsv"
    _binary_table(d, snarls, ours)
    _h, ref_rows = _read_keyed(ref_out / "binary_table_vcf.tsv")
    _h, our_rows = _read_keyed(ours)
    assert set(ref_rows) == set(our_rows)
    for key, rc_ in ref_rows.items():
        oc = our_rows[key]
        # P_FISHER, P_CHI2, GROUP_PATHS, DEPTH must agree exactly
        assert rc_[5:7] == oc[5:7], key
        assert rc_[8] == oc[8], key
