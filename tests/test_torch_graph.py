"""Parity of the port's graph mode (K6 and ``stoat graph``) with the JAX
package, on the CPU.

The same numpy partition counts, made from a seed, go through stoat_tpu's
``_graph_stats_fused`` and the port's ``graph_stats_plain``.  Tolerances:
Fisher to a relative 4.5e-16 with identical ``format_p`` strings (the
same float64 operations in the same order, but XLA on the CPU contracts
some multiply-adds: about 7% of the p-values differ in the last bit; the
card's kernel is held bitwise to the plain version by chip_smoke.py); the
two chi-squared statistics to a relative 1e-15 (sums of at most 8 terms, in
column order here and in XLA's order there); the chi-squared p-values to
a relative 1e-12 with identical ``format_p`` strings, as the ``vcf -b``
tests hold them (both run JAX's igammac; their logarithms, exponentials
and divisions come from other libraries).  Whole ``graph`` runs of both CLIs, on a
graph written by chip_smoke.py's generator, must write the same bytes.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from stoat_tpu import cli as jax_cli
from stoat_tpu.graph.association import _graph_stats_fused
from stoat_tpu.stats.chi2 import chi2_2x2_stat as j_chi2_2x2_stat
from stoat_tpu.stats.chi2 import chi2_2xn_stat as j_chi2_2xn_stat
from stoat_tpu.writer import format_p
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.convert import to_graph_counts
from stoat_tpu_torch.graph import association as assoc
from stoat_tpu_torch.stats.chi2 import chi2_2x2_stat, chi2_2xn_stat
from test_torch_cli import _chip_smoke

CPU = torch.device("cpu")


def _counts(seed, B=600, Pmax=8):
    """[B, Pmax] int32 control/case counts with k = 2..Pmax columns, rows
    with a zero margin and rows with a zero column."""
    rng = np.random.default_rng(seed)
    k = rng.integers(2, Pmax + 1, B)
    k[:100] = 2
    mask = np.arange(Pmax)[None, :] < k[:, None]
    G0 = np.where(mask, rng.integers(0, 60, (B, Pmax)), 0).astype(np.int32)
    G1 = np.where(mask, rng.integers(0, 60, (B, Pmax)), 0).astype(np.int32)
    G0[100:130] = 0                                 # a zero row margin
    G1[130:150, :2] = 0
    G0[130:150, 0] = 0                              # a zero column
    G1[150:170, 1] = 0
    G0[150:170, 1] = 0
    G0[170:180], G1[170:180] = 0, 0                 # empty tables
    return G0, G1, mask


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rel, atol=0)


@pytest.mark.parametrize("seed,Pmax", [(0, 8), (1, 3), (2, 2), (3, 5)])
def test_graph_stats_plain_matches_jax(seed, Pmax):
    G0, G1, mask = _counts(seed, Pmax=Pmax)
    want = [np.asarray(w) for w in _graph_stats_fused(G0, G1, mask)]
    got = [g.numpy() for g in assoc.graph_stats(
        torch.from_numpy(G0), torch.from_numpy(G1), torch.from_numpy(mask))]
    p22, pf, pn = got
    _rel_close(pf, want[1], 4.5e-16)
    assert [format_p(v) for v in pf] == [format_p(v) for v in want[1]]
    for g, w in ((p22, want[0]), (pn, want[2])):
        _rel_close(g, w, 1e-12)
        assert [format_p(v) for v in g] == [format_p(v) for v in w]
    assert np.isnan(pf[100:130]).all() and np.isnan(pn[170:180]).all()
    # the statistics themselves
    cols = [torch.from_numpy(a) for a in (G0[:, 0], G0[:, 1], G1[:, 0],
                                          G1[:, 1])]
    for g, w in zip(chi2_2x2_stat(*cols),
                    j_chi2_2x2_stat(G0[:, 0], G0[:, 1], G1[:, 0], G1[:, 1])):
        _rel_close(g.numpy(), np.asarray(w), 1e-15)
    for g, w in zip(chi2_2xn_stat(torch.from_numpy(G0), torch.from_numpy(G1),
                                  torch.from_numpy(mask)),
                    j_chi2_2xn_stat(G0, G1, mask)):
        _rel_close(g.numpy(), np.asarray(w), 1e-15)


def test_graph_stats_one_allocation_one_launch(monkeypatch):
    """The CUDA wrapper's one launch and one [3, B] allocation: the three
    p-values are its rows, where the launch writes them (a stand-in launch
    copies the plain version's outputs through the pointers), and nothing
    else runs (the tails are inside the launch)."""
    import ctypes
    G0, G1, mask = (torch.from_numpy(a) for a in _counts(4, B=300, Pmax=5))
    want = assoc.graph_stats_plain(G0, G1, mask)
    calls = []

    def fake_launch(name, argtypes, values, device):
        assert name == "graph_stats" and len(values) == len(argtypes) == 8
        assert values[:3] == [G0.data_ptr(), G1.data_ptr(), mask.data_ptr()]
        assert values[6:] == [300, 5]
        for ptr, src in zip(values[3:6], want):
            ctypes.memmove(ptr, src.data_ptr(), src.numel() * 8)
        calls.append(name)

    def no_tail(*a, **k):
        raise AssertionError("a tail outside the launch")
    monkeypatch.setattr(assoc, "launch", fake_launch)
    monkeypatch.setattr(assoc, "finish_chi2_pvalues", no_tail)
    got = assoc._graph_stats_cuda(G0, G1, mask)
    assert calls == ["graph_stats"]
    assert len({t.untyped_storage().data_ptr() for t in got}) == 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float64 and tuple(g.shape) == (300,)
        assert g.is_contiguous()
        assert g.data_ptr() == got[0].data_ptr() + 8 * 300 * i
        np.testing.assert_array_equal(g.view(torch.int64).numpy(),
                                      w.view(torch.int64).numpy())


def test_to_graph_counts_scatters_the_ragged_counts():
    kinds = np.array([1, 0, 1, 1, 0], np.uint8)
    offs = np.array([0, 2, 2, 5, 7, 7], np.int64)
    g0 = np.arange(7, dtype=np.uint32)
    g1 = np.arange(7, dtype=np.uint32) + 10
    G0, G1, mask, k = to_graph_counts(kinds, offs, g0, g1, CPU)
    assert k.tolist() == [2, 3, 2]
    assert G0.dtype == torch.int32 and tuple(G0.shape) == (3, 3)
    assert G0.tolist() == [[0, 1, 0], [2, 3, 4], [5, 6, 0]]
    assert G1.tolist() == [[10, 11, 0], [12, 13, 14], [15, 16, 0]]
    assert mask.tolist() == [[True, True, False], [True, True, True],
                             [True, True, False]]
    G0, _, _, k = to_graph_counts(np.zeros(2, np.uint8), offs[:3], g0, g1,
                                  CPU)
    assert tuple(G0.shape) == (0, 2) and not len(k)
    with pytest.raises(ValueError, match="int32"):
        to_graph_counts(kinds, offs, g0, g1 + np.uint32(2 ** 31), CPU)


@pytest.fixture(scope="module")
def graph_files(tmp_path_factory):
    """The generator's graph at 400 snarls x 16 samples (32 haplotype
    paths), and the same graph as a .gbz."""
    from stoat_tpu.graph.gbz_write import save_gbz
    from stoat_tpu.graph.gfa import load_gfa

    tmp = tmp_path_factory.mktemp("torch_graph")
    files = _chip_smoke().write_graph(str(tmp / "data"), 400, 16, seed=3)
    files["gbz"] = str(tmp / "data" / "graph.gbz")
    save_gbz(load_gfa(files["gfa"], {"ref"}), files["gbz"])
    return files, tmp


@pytest.mark.parametrize("method", ["chi2", "exact"])
@pytest.mark.parametrize("fmt", ["tsv", "fasta"])
@pytest.mark.parametrize("source,python", [("gfa", "0"), ("gfa", "1"),
                                           ("gbz", "0")])
def test_graph_cli_byte_identical(graph_files, monkeypatch, method, fmt,
                                  source, python):
    """``python -m stoat_tpu_torch graph ... --device cpu`` writes the bytes
    of ``python -m stoat_tpu graph ...``: native prepare on GFA and GBZ,
    and the Python twin (STOAT_GRAPH_PYTHON=1), each counted."""
    files, tmp = graph_files
    monkeypatch.setenv("STOAT_GRAPH_PYTHON", python)
    tag = f"{method}_{fmt}_{source}_{python}"
    argv = ["graph", "-p", files[source], "-d", files["gfa"], "-b",
            files["pheno"], "-T", method, "-O", fmt, "-r", "ref", "-V", "0"]
    assert jax_cli.main(argv + ["-o", str(tmp / f"jax_{tag}")]) == 0
    before = dict(assoc.GRAPH_PATHS)
    assert torch_cli.main(argv + ["-o", str(tmp / f"torch_{tag}"),
                                  "--device", "cpu"]) == 0
    path = "python" if python == "1" else "native"
    assert assoc.GRAPH_PATHS[path] == before[path] + 1
    name = "binary_table_graph.tsv" if fmt == "tsv" else "binary_output.fasta"
    with open(tmp / f"jax_{tag}" / name, "rb") as fh:
        want = fh.read()
    with open(tmp / f"torch_{tag}" / name, "rb") as fh:
        assert fh.read() == want
    if fmt == "tsv":
        assert want.count(b"\n") > (400 if method == "chi2" else 2)
    else:
        assert want.count(b"\n>") > (400 if method == "chi2" else 2)


def test_graph_cli_cuda_without_card_writes_nothing(graph_files, tmp_path):
    """``graph --device cuda`` with no card is an error before any
    output, never a run on the CPU."""
    if torch.cuda.is_available():
        return
    files, _ = graph_files
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_cli.main(["graph", "-p", files["gfa"], "-d", files["gfa"],
                        "-b", files["pheno"], "-o", str(out)])
    assert not out.exists()
