"""Randomized differential testing: native graph pipeline vs Python twin.

The fixture zoo (test_decompose_zoo, test_graph_contract) pins curated
shapes; this file drives RANDOM small graphs — mixed bubble arities,
deletion edges, inversions in sample paths, dangling branches — through
both the native one-call prepare (graph_core.cpp) and the readable
Python pipeline, asserting byte-identical TSV and FASTA output.  Any
divergence in the from-scratch snarl finder / partitioner / walk shows
up here first.

The JAX suite's test (tests/test_graph_fuzz.py) on the port's ``graph``
run on the CPU, on the same random graphs (its ``_random_graph``), each
run also byte for byte ``stoat_tpu``'s
(``test_torch_graph_association.run_graph_association``).
"""

import filecmp

import pytest

pytest.importorskip("torch")

from test_graph_fuzz import _random_graph
from test_torch_graph_association import run_graph_association


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("method,fmt", [("chi2", "tsv"), ("chi2", "fasta"),
                                        ("exact", "tsv")])
def test_native_python_differential(tmp_path, seed, method, fmt,
                                    monkeypatch):
    from stoat_tpu_torch.native import get_graph_lib

    if get_graph_lib() is None:
        pytest.skip("native graph core unavailable")
    gfa, pheno = _random_graph(tmp_path, seed)
    out_n = tmp_path / f"n_{seed}_{method}_{fmt}"
    out_p = tmp_path / f"p_{seed}_{method}_{fmt}"
    out_n.mkdir()
    out_p.mkdir()
    rc_n = run_graph_association(gfa, "", pheno, method, fmt, 0, "ref",
                                 str(out_n))
    monkeypatch.setenv("STOAT_GRAPH_PYTHON", "1")
    rc_p = run_graph_association(gfa, "", pheno, method, fmt, 0, "ref",
                                 str(out_p))
    monkeypatch.delenv("STOAT_GRAPH_PYTHON")
    assert rc_n == rc_p
    if rc_n != 0:
        return
    name = ("binary_table_graph.tsv" if fmt == "tsv"
            else "binary_output.fasta")
    assert filecmp.cmp(out_n / name, out_p / name, shallow=False), \
        f"divergence at seed={seed} method={method} fmt={fmt}"
