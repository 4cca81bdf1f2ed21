"""Native C++ snarl decomposition: parity with the Python implementation.

The Python decomposition is the readable reference; the C++ core must
produce the same snarl records (keyed by SNARL id, paths sorted
canonically) on the fixture zoo and on random bubble-chain graphs.

The JAX suite's tests (tests/test_native_decompose.py) on the port's
``graph/`` and ``native/graph_core.cpp``; stoat_tpu's native core also
writes the same snarl and reject text on each graph.
"""

import io
import os

import numpy as np
import pytest

from stoat_tpu_torch.graph.gfa import load_gfa
from stoat_tpu_torch.graph.decompose import decompose_graph

pytest.importorskip("torch")
native = pytest.importorskip("stoat_tpu_torch.native")

from stoat_tpu import native as jax_native  # noqa: E402
from test_graph_decompose import build_gfa  # noqa: E402
from test_native_decompose import REF_GFA, ZOO  # noqa: E402


@pytest.fixture(scope="module")
def graph_lib():
    if native.get_graph_lib() is None or jax_native.get_graph_lib() is None:
        pytest.skip("native graph core toolchain unavailable")


def python_decompose_tsv(gfa_path, refs):
    g = load_gfa(gfa_path, refs)
    out = io.StringIO()
    fail = io.StringIO()
    from stoat_tpu_torch.io.snarl_file import (write_snarl_fail_header,
                                         write_snarl_file_header)
    write_snarl_file_header(out)
    write_snarl_fail_header(fail)
    decompose_graph(g, refs, out_snarl=out, out_fail=fail)
    return out.getvalue(), fail.getvalue()


def rows_by_snarl(tsv):
    rows = {}
    for line in tsv.splitlines()[1:]:
        cols = line.split("\t")
        # drop SNARL_HANDLEGRAPH (col 3): an internal index, not a contract
        rows[cols[4]] = cols[:3] + cols[4:]
    return rows


def assert_parity(gfa_path, refs={"ref"}):
    py_tsv, py_rej = python_decompose_tsv(gfa_path, refs)
    nat_tsv, nat_rej = native.native_decompose_gfa(gfa_path, refs)
    assert (nat_tsv, nat_rej) == jax_native.native_decompose_gfa(gfa_path,
                                                                 refs)
    py_rows = rows_by_snarl(py_tsv)
    nat_rows = rows_by_snarl(nat_tsv)
    assert py_rows.keys() == nat_rows.keys()
    for sid in py_rows:
        assert py_rows[sid] == nat_rows[sid], sid
    assert sorted(py_rej.splitlines()) == sorted(nat_rej.splitlines())


@pytest.mark.skipif(not os.path.exists(REF_GFA), reason="fixture missing")
def test_reference_fixture_parity(graph_lib):
    assert_parity(REF_GFA)


def test_three_allele_parity(graph_lib, tmp_path):
    path = build_gfa(
        tmp_path,
        [(1, "TTTT"), (2, "AAAA"), (3, "C"), (4, "G"), (5, "T"),
         (6, "AAAA")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (2, "+", 4, "+"),
         (2, "+", 5, "+"), (3, "+", 6, "+"), (4, "+", 6, "+"),
         (5, "+", 6, "+")],
        [("ref", "1+,2+,3+,6+")])
    assert_parity(path)


def test_nested_parity(graph_lib, tmp_path):
    path = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "TT"), (3, "CC"), (4, "G"), (5, "A"),
         (6, "CC"), (7, "AAAA")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (3, "+", 4, "+"),
         (3, "+", 5, "+"), (4, "+", 6, "+"), (5, "+", 6, "+"),
         (6, "+", 7, "+"), (1, "+", 7, "+")],
        [("ref", "1+,2+,3+,4+,6+,7+")])
    assert_parity(path)


def test_inversion_and_loop_parity(graph_lib, tmp_path):
    path = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "ACGT"), (3, "TTTT"), (4, "C"), (5, "GG")],
        [(1, "+", 2, "+"), (1, "+", 2, "-"), (2, "+", 3, "+"),
         (2, "-", 3, "+"), (3, "+", 4, "+"), (4, "+", 4, "+"),
         (4, "+", 5, "+")],
        [("ref", "1+,2+,3+,4+,5+")])
    assert_parity(path)


def test_random_chain_parity(graph_lib, tmp_path):
    rng = np.random.default_rng(5)
    segments = []
    links = []
    node = 1
    ref = []
    for k in range(50):
        n_all = int(rng.integers(2, 5))
        start = node
        mids = list(range(node + 1, node + 1 + n_all))
        end = node + n_all + 1
        segments.append((start, "ACGT"))
        for m in mids:
            segments.append((m, "A" * int(rng.integers(1, 6))))
            links.append((start, "+", m, "+"))
            links.append((m, "+", end, "+"))
        if k % 4 == 1:
            links.append((start, "+", end, "+"))  # deletion edge
        ref.append(f"{start}+")
        ref.append(f"{mids[0]}+")
        node = end
    segments.append((node, "ACGT"))
    ref.append(f"{node}+")
    path = build_gfa(tmp_path, segments, links, [("ref", ",".join(ref))])
    assert_parity(path)


@pytest.mark.skipif(not os.path.isdir(ZOO), reason="zoo unavailable")
def test_zoo_wide_native_python_parity(graph_lib, tmp_path):
    """Python and C++ decompositions agree on every .hg fixture."""
    import glob
    from stoat_tpu_torch.graph.hashgraph import load_hg
    checked = 0
    for hg in sorted(glob.glob(os.path.join(ZOO, "*.hg"))):
        name = os.path.basename(hg)[:-3]
        g = load_hg(hg, {"ref"})
        gfa = str(tmp_path / f"{name}.gfa")
        g.write_gfa(gfa)
        try:
            assert_parity(gfa, {"ref"})
            checked += 1
        except RuntimeError as e:
            # graphs without a flagged ref path raise "paths = 0" in both
            assert "0" in str(e) or "paths" in str(e), (name, e)
    assert checked >= 15


def test_random_graph_fuzz_parity(graph_lib, tmp_path):
    """Round-5: randomized differential decomposition — the same random
    graphs the association fuzz drives (mixed arities, deletion edges,
    dangling branches) must decompose identically through the C++ and
    Python twins, keyed per snarl with identical reject sets."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_graph_fuzz import _random_graph

    for seed in range(10):
        d = tmp_path / f"s{seed}"
        d.mkdir()
        gfa, _pheno = _random_graph(d, seed)
        assert_parity(gfa, refs={"ref"})
