"""Parity of the port's quantitative design (K1, K7, K8) and chunk
pipeline with the JAX package.

The same numpy inputs, made from a seed, go through stoat_tpu's
``membership_words``, ``unpack_membership``, ``_design_from_membership``
and ``quantitative_analyze_chromosome`` (XLA on the CPU) and through the
port's plain PyTorch versions.  Tolerances: membership, counts, flags and
``ncols`` exact; X at a relative 1e-15 (both compute each entry as one
float64 product of an integer count and the row's reciprocal, so it is
bitwise in practice); the chunk statistics at a relative 1e-9, as the
OLS tests state (sums over the rows run in another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from stoat_tpu.pipeline import packed as jpk
from stoat_tpu.pipeline.quantitative import (
    _design_from_membership, quantitative_analyze_chromosome as j_analyze)
from stoat_tpu_torch.pipeline import packed as tpk
from stoat_tpu_torch.pipeline.quantitative import (
    DESIGN_KEYS, design_from_membership_plain,
    quantitative_analyze_chromosome)

THRESHOLDS = (3, 5, 0.05)


def _words_case(seed, E=37, H=101, P=23, max_k=5):
    rng = np.random.default_rng(seed)
    matrix = rng.random((E, H)) < 0.7
    valid = rng.random(P) < 0.85
    coo_path, coo_row = [], []
    for p in range(P):
        for _ in range(rng.integers(1, max_k + 1)):
            coo_path.append(p)
            coo_row.append(rng.integers(0, E))
    words = tpk.pack_matrix_words(matrix)
    idx = tpk.pack_path_edge_idx(np.array(coo_path, np.int32),
                                 np.array(coo_row, np.int32), valid, E)
    return words, idx, valid


def _t32(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32).copy())


@pytest.mark.parametrize("seed,H", [(0, 101), (1, 96), (2, 32), (3, 7),
                                    (4, 130)])
def test_membership_words_and_unpack_match_jax(seed, H):
    """K1 alone and K7: words equal bit for bit (sign bit included), the
    unpacked [P, H] membership exactly (bits past H dropped, invalid paths
    all False)."""
    words, idx, valid = _words_case(seed, H=H)
    jmem = jpk.membership_words(jnp.asarray(words), jnp.asarray(idx))
    mem = tpk.membership_words_plain(_t32(words), torch.from_numpy(idx))
    np.testing.assert_array_equal(mem.numpy().view(np.uint32),
                                  np.asarray(jmem))
    want = np.asarray(jpk.unpack_membership(jmem, jnp.asarray(valid), H))
    got = tpk.unpack_membership_plain(mem, torch.from_numpy(valid), H)
    assert got.dtype == torch.bool and got.shape == (idx.shape[0], H)
    np.testing.assert_array_equal(got.numpy(), want)


def _membership_case(seed, N=40, S=24, Pmax=5):
    """A random [P, H] membership and [S, Pmax] path index, with snarls
    built to hit every rule: duplicate columns among >= 3 kept (the merge
    fires), three identical columns (degenerate), two identical columns
    (no merge), empty columns, -1 padding and few carriers (filtered)."""
    rng = np.random.default_rng(seed)
    H = 2 * N
    rows, sidx = [], np.full((S, Pmax), -1, np.int32)

    def add(col):
        rows.append(col)
        return len(rows) - 1

    for s in range(S):
        kind = s % 6
        n = int(rng.integers(2, Pmax + 1))
        cols = [rng.random(H) < rng.uniform(0.1, 0.6) for _ in range(n)]
        if kind == 1 and n >= 3:            # merge: two equal columns
            cols[2] = cols[0].copy()
        elif kind == 2:                     # degenerate: three equal ones
            n = 3
            cols = [cols[0].copy(), cols[0].copy(), cols[0].copy()]
        elif kind == 3:                     # an empty column
            cols[-1][:] = False
        elif kind == 4:                     # two equal columns only
            n = 2
            cols = [cols[0].copy(), cols[0].copy()]
        elif kind == 5:                     # few carriers
            for c in cols:
                c[6:] = False
        for j, col in enumerate(cols[:n]):
            sidx[s, j] = add(col)
    membership = np.array(rows, bool)
    return membership, sidx


def _compare_design(got, want):
    for key in DESIGN_KEYS:
        g = got[key].numpy()
        w = np.asarray(want[key])
        assert g.shape == w.shape, key
        if key == "X":
            np.testing.assert_allclose(g, w, rtol=1e-15, atol=0)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), key)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("C", [0, 2])
def test_design_from_membership_matches_jax(seed, C):
    membership, sidx = _membership_case(seed)
    N = membership.shape[1] // 2
    covar = np.random.default_rng(seed + 10).standard_normal((N, C))
    for thresholds in ((2, 2, 0.0), THRESHOLDS):
        want = _design_from_membership(
            jnp.asarray(membership), jnp.asarray(sidx),
            jnp.asarray(covar), *map(jnp.float64, thresholds),
            with_covar=C > 0, all_rows=False)
        got = design_from_membership_plain(
            torch.from_numpy(membership), torch.from_numpy(sidx),
            torch.from_numpy(covar), *thresholds)
        _compare_design(got, want)
    # the case mix really ran: merges, degenerate snarls, filtered ones
    assert got["degenerate"].any() and got["filtered"].any()
    assert (~got["filtered"]).any()
    kept = (got["allele_paths"] > 0).sum(dim=1)
    assert ((got["ncols"] - 1 - C) < kept - 1).any()     # a merge fired


GRID_CASES = ["pmax1", "n37", "two_tiles", "pmax_max"]


@pytest.mark.parametrize("all_rows", [False, True])
@pytest.mark.parametrize("C", [0, 2])
@pytest.mark.parametrize("case", GRID_CASES)
def test_design_grid_matches_jax(case, C, all_rows):
    """chip_smoke.py's grid at the edges of the kernel's design (Pmax = 1,
    a part-filled last word, merges in every position, an all-invalid
    snarl, two word tiles, the widest Pmax), from the packed words through
    K1, K7 and K8 with the table view: X and norm bit for bit, the rest
    exactly."""
    from stoat_tpu.pipeline import quantitative as jq
    from stoat_tpu_torch.convert import DeviceChunk
    from stoat_tpu_torch.pipeline.quantitative import (TABLE_KEYS,
                                                       quant_design_plain)
    from test_torch_cli import _chip_smoke
    grid = {name: (arrays, H)
            for name, arrays, H in _chip_smoke().quant_grid_chunks()}
    assert sorted(grid) == sorted(GRID_CASES)
    (words, idx, valid, sidx), H = grid[case]
    covar = np.random.default_rng(C).standard_normal((H // 2, C))
    want = jq._design_packed_body(
        jnp.asarray(words.view(np.uint32)), jnp.asarray(idx),
        jnp.asarray(valid), jnp.asarray(sidx), jnp.asarray(covar),
        *map(jnp.float64, THRESHOLDS), n_haplotypes=H, with_covar=C > 0,
        all_rows=all_rows)
    chunk = DeviceChunk(*(torch.from_numpy(a) for a in (words, idx, valid,
                                                        sidx)))
    got = quant_design_plain(chunk, torch.from_numpy(covar), *THRESHOLDS, H,
                             all_rows=all_rows, tables=True)
    for key in DESIGN_KEYS + TABLE_KEYS:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if g.dtype == np.float64:
            np.testing.assert_array_equal(g.view(np.uint64),
                                          w.view(np.uint64), key)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), key)


def _fixture_chunks(tmp_path, seed, n_samples, n_snarls, chunk):
    from fixtures import make_fixture
    from stoat_tpu.io.phenotype import (parse_covariates,
                                        parse_quantitative_pheno)
    from stoat_tpu.io.snarl_file import parse_snarl_path
    from stoat_tpu.tables import pack_chromosome_chunks
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices

    paths = make_fixture(str(tmp_path), n_samples=n_samples,
                         n_snarls=n_snarls, seed=seed)
    samples = list(paths["samples"])
    pheno = parse_quantitative_pheno(paths["quantitative"], samples)
    covar = parse_covariates(paths["covariate"], ["AGE", "SEX"], samples)
    snarls_chr = parse_snarl_path(paths["snarl"])
    packs = []
    for chrom, matrix in iter_chromosome_matrices(
            paths["vcf"], 2 * len(samples), snarls_chr):
        packs += pack_chromosome_chunks(snarls_chr[chrom], matrix, chunk)
    return packs, pheno, covar


@pytest.mark.parametrize("seed,with_covar", [(0, False), (1, True),
                                             (2, True)])
def test_quantitative_chunks_match_jax(tmp_path, seed, with_covar):
    """Whole fixture chunks through both packages' chunk pipelines."""
    from stoat_tpu.writer import format_p
    from stoat_tpu_torch.convert import to_quant_inputs

    packs, pheno, covar = _fixture_chunks(tmp_path, seed, 60, 50, 16)
    covar = covar if with_covar else None
    cpu = torch.device("cpu")
    tpheno, tcovar = to_quant_inputs(pheno, covar, 60, cpu)
    assert tcovar.shape == (60, 2 if with_covar else 0)
    assert len(packs) == 4
    for packed in packs:
        want = j_analyze(packed, pheno, covar, *THRESHOLDS)
        got = quantitative_analyze_chromosome(packed, tpheno, tcovar,
                                              *THRESHOLDS, cpu)
        assert sorted(got) == sorted(want)
        for key in ("filtered", "allele_paths"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        for key in ("p", "beta", "se", "r2"):
            g, w = got[key], np.asarray(want[key])
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            ok = ~np.isnan(w)
            np.testing.assert_allclose(g[ok], w[ok], rtol=1e-9, atol=0)
            assert [format_p(v) for v in g] == [format_p(v) for v in w]
