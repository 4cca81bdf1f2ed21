"""--resume: per-chromosome checkpoint/restart of the analysis phase.

The reference's only checkpoint is the snarl decomposition cache
(`snarl_analyse.tsv`, vcf.cpp:317-319); an interrupted GWAS restarts
from scratch.  stoat-tpu checkpoints every completed chromosome in a
fsynced ``<output>.progress`` sidecar (runner._record_progress): resume
skips complete chromosomes, truncates a partially-written one, and the
final TSV is byte-identical to an uninterrupted run.

The JAX suite's tests (tests/test_resume.py) on the port's runner, called
with its own signature (phenotype and device) on the CPU; each final
table is also byte for byte ``stoat_tpu``'s uninterrupted run.
"""

import filecmp
import os

import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.pipeline.runner import run_vcf_analysis as jax_run
from stoat_tpu_torch.io.phenotype import (parse_binary_pheno,
                                          parse_quantitative_pheno)
from stoat_tpu_torch.io.snarl_file import parse_snarl_path
from stoat_tpu_torch.pipeline.runner import (_progress_path,
                                             _read_progress,
                                             run_vcf_analysis)

from fixtures import make_fixture

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    paths = make_fixture(str(tmp), n_samples=24, n_snarls=36, seed=31,
                         n_chroms=3)
    snarls_chr = parse_snarl_path(paths["snarl"])
    pheno_b, samples = parse_binary_pheno(paths["binary"],
                                          list(paths["samples"]))
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    return paths, snarls_chr, pheno_b, pheno_q, samples, tmp


def _run(paths, snarls_chr, pheno_b, samples, out, **kw):
    return run_vcf_analysis(paths["vcf"], snarls_chr, out, pheno_b, CPU,
                            sample_names=samples, **kw)


def _same_as_stoat_tpu(paths, snarls_chr, pheno_b, samples, out, tmp_path,
                       **kw):
    """``out`` is byte for byte stoat_tpu's uninterrupted run."""
    twin = str(tmp_path / "stoat_tpu.tsv")
    jax_run(paths["vcf"], snarls_chr, twin, "binary",
            binary_phenotype=pheno_b, sample_names=samples, use_mesh=False,
            **kw)
    assert filecmp.cmp(out, twin, shallow=False)


def test_progress_sidecar_written(data, tmp_path):
    paths, snarls_chr, pheno_b, _q, samples, _ = data
    out = str(tmp_path / "full.tsv")
    _run(paths, snarls_chr, pheno_b, samples, out)
    prog = _read_progress(out)
    assert list(prog) == list(snarls_chr)     # every chromosome recorded
    assert os.path.getsize(out) == prog[list(prog)[-1]]
    _same_as_stoat_tpu(paths, snarls_chr, pheno_b, samples, out, tmp_path)


def test_resume_after_partial_run(data, tmp_path):
    """Truncate the output mid-chromosome-2 (simulated crash), drop the
    incomplete progress entries, resume — byte-identical final TSV, and
    the completed chromosome is NOT re-analyzed."""
    import stoat_tpu_torch.pipeline.runner as runner_mod

    paths, snarls_chr, pheno_b, _q, samples, _ = data
    ref_out = str(tmp_path / "ref.tsv")
    _run(paths, snarls_chr, pheno_b, samples, ref_out)

    out = str(tmp_path / "crash.tsv")
    _run(paths, snarls_chr, pheno_b, samples, out)
    prog = _read_progress(out)
    chroms = list(prog)
    assert len(chroms) == 3
    # simulated crash: chromosome 1 complete, chromosome 2 half-written,
    # its progress entry (and chromosome 3 entirely) lost
    keep_off = prog[chroms[0]]
    with open(out, "r+b") as fh:
        fh.truncate(keep_off + 37)            # partial chrom-2 rows
    with open(_progress_path(out), "w") as fh:
        fh.write(f"{chroms[0]}\t{keep_off}\n")

    analyzed = []
    orig = runner_mod._analyze

    def spy(run, key, mode, phenotype, packed, *a, **k):
        analyzed.append(len(packed.snarls))
        return orig(run, key, mode, phenotype, packed, *a, **k)

    runner_mod._analyze = spy
    try:
        _run(paths, snarls_chr, pheno_b, samples, out, resume=True)
    finally:
        runner_mod._analyze = orig
    assert filecmp.cmp(out, ref_out, shallow=False)
    _same_as_stoat_tpu(paths, snarls_chr, pheno_b, samples, out, tmp_path)
    # only chromosomes 2 and 3 were re-analyzed; chromosome 1's snarls
    # never reached the device
    n_c1 = len(snarls_chr[chroms[0]])
    n_rest = sum(len(snarls_chr[c]) for c in chroms[1:])
    assert sum(analyzed) == n_rest, (sum(analyzed), n_rest, n_c1)


def test_resume_with_nothing_done_restarts(data, tmp_path):
    paths, snarls_chr, pheno_b, _q, samples, _ = data
    out = str(tmp_path / "fresh.tsv")
    _run(paths, snarls_chr, pheno_b, samples, out, resume=True)
    ref_out = str(tmp_path / "ref2.tsv")
    _run(paths, snarls_chr, pheno_b, samples, ref_out)
    assert filecmp.cmp(out, ref_out, shallow=False)
    _same_as_stoat_tpu(paths, snarls_chr, pheno_b, samples, out, tmp_path)


def test_resume_dual_requires_joint_completion(data, tmp_path):
    """Dual runs: a chromosome checkpointed in only ONE of the two
    outputs is re-run whole; final TSVs byte-identical to a clean run."""
    paths, snarls_chr, pheno_b, pheno_q, samples, _ = data

    def dual(b, q, **kw):
        return run_vcf_analysis(
            paths["vcf"], snarls_chr, b, pheno_b, CPU, sample_names=samples,
            secondary={"mode": "quantitative", "output_tsv": q,
                       "quantitative_phenotype": pheno_q}, **kw)

    rb, rq = str(tmp_path / "rb.tsv"), str(tmp_path / "rq.tsv")
    dual(rb, rq)
    b, q = str(tmp_path / "b.tsv"), str(tmp_path / "q.tsv")
    dual(b, q)
    prog_b = _read_progress(b)
    chroms = list(prog_b)
    # keep chrom 1+2 in the primary but only chrom 1 in the secondary:
    # the joint prefix is chrom 1 only
    with open(_progress_path(b), "w") as fh:
        fh.write(f"{chroms[0]}\t{prog_b[chroms[0]]}\n"
                 f"{chroms[1]}\t{prog_b[chroms[1]]}\n")
    prog_q = _read_progress(q)
    with open(_progress_path(q), "w") as fh:
        fh.write(f"{chroms[0]}\t{prog_q[chroms[0]]}\n")
    with open(b, "r+b") as fh:
        fh.truncate(prog_b[chroms[1]])
    with open(q, "r+b") as fh:
        fh.truncate(prog_q[chroms[0]] + 11)   # partial secondary rows
    dual(b, q, resume=True)
    assert filecmp.cmp(b, rb, shallow=False)
    assert filecmp.cmp(q, rq, shallow=False)
    jb, jq = str(tmp_path / "jb.tsv"), str(tmp_path / "jq.tsv")
    jax_run(paths["vcf"], snarls_chr, jb, "binary", binary_phenotype=pheno_b,
            sample_names=samples, use_mesh=False,
            secondary={"mode": "quantitative", "output_tsv": jq,
                       "quantitative_phenotype": pheno_q})
    assert filecmp.cmp(b, jb, shallow=False)
    assert filecmp.cmp(q, jq, shallow=False)
