"""eQTL pair regression with the pair axis split over a mesh
(parallel/sharded.py eqtl_regress_pairs_sharded), against stoat_tpu's
tests/test_eqtl_sharded.py: the same fixtures, seeds and random pairs
(in any snarl order, not a multiple of the mesh size).  Tolerances:
bitwise the port's one-device pair regression (each pair's regression is
independent of the cut); stoat_tpu's within 1e-9 relative with equal
``format_p`` strings (PERF.md §2's regression rule).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu import parallel as jpar
from stoat_tpu.io.snarl_file import parse_snarl_path as j_snarls
from stoat_tpu.io.vcf import VcfReader as JReader
from stoat_tpu.matrix import EdgeHaplotypeMatrix as JMatrix
from stoat_tpu.pipeline import quantitative as jq
from stoat_tpu.tables import pack_chromosome as j_pack
from stoat_tpu.writer import format_p
from stoat_tpu_torch.convert import to_covariates, to_eqtl_pairs, upload
from stoat_tpu_torch.io.snarl_file import parse_snarl_path
from stoat_tpu_torch.io.vcf import VcfReader
from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix
from stoat_tpu_torch.parallel import (eqtl_regress_pairs_sharded,
                                      make_snarl_mesh)
from stoat_tpu_torch.pipeline import quantitative as tq
from stoat_tpu_torch.tables import pack_chromosome

TH = (3, 5, 0.05)
CPU = torch.device("cpu")
KEYS = ("p", "beta", "se", "r2")


def _designs(tmp_path, seed):
    """The fixture's eQTL design in both packages (40 samples, 16
    snarls, no covariates)."""
    paths = make_fixture(str(tmp_path), n_samples=40, n_snarls=16,
                         seed=seed)
    out = []
    for reader_cls, matrix_cls, parse, pack in (
            (VcfReader, EdgeHaplotypeMatrix, parse_snarl_path,
             pack_chromosome),
            (JReader, JMatrix, j_snarls, j_pack)):
        reader = reader_cls(paths["vcf"])
        _, records = next(iter(reader.chromosome_chunks()))
        matrix = matrix_cls(80)
        for rec in records:
            matrix.add_record(rec)
        reader.close()
        out.append(pack(parse(paths["snarl"])["ref"], matrix))
    packed, jpacked = out
    design = tq.eqtl_design_for_chromosome(packed, to_covariates(None, 40,
                                                                 CPU),
                                           *TH, CPU)
    return packed, design, jq.eqtl_design_for_chromosome(jpacked, None, *TH)


def _one_device(design, pair_snarl, expr):
    """The port's one-device pair regression (pairs in snarl order, as it
    takes them), back in the given order."""
    order = np.argsort(pair_snarl, kind="stable")
    B = len(pair_snarl)
    res = tq.eqtl_regress_pairs(
        design, *to_eqtl_pairs(pair_snarl[order], order,
                               int(design["X"].shape[0]), CPU),
        upload(expr, CPU))
    back = np.empty(B, np.int64)
    back[order] = np.arange(B)
    return {k: np.asarray(res[k])[back] for k in KEYS}


def _hold(got, want, deg, keys):
    for i in range(len(deg)):
        if deg[i]:
            continue
        for key in keys:
            assert format_p(got[key][i]) == format_p(want[key][i]), (i, key)
            np.testing.assert_allclose(got[key][i], want[key][i], rtol=1e-9,
                                       atol=0, err_msg=key)


@pytest.mark.parametrize("n", [8, 3])
def test_eqtl_pairs_gspmd_parity(tmp_path, n):
    """The pair batch split over the mesh gives stoat_tpu's single-device
    eqtl_regress_pairs (the port of its GSPMD test: 16 pairs, seed 19)."""
    packed, design, jdesign = _designs(tmp_path, 19)
    rng = np.random.default_rng(0)
    B = 16
    pair_snarl = rng.integers(0, packed.n_snarls, B)
    expr = rng.standard_normal((B, 40))
    base = jq.eqtl_regress_pairs(jdesign, pair_snarl, expr)
    res = eqtl_regress_pairs_sharded(design, pair_snarl, np.arange(B), expr,
                                     make_snarl_mesh([CPU] * n))
    deg = np.asarray(jdesign["degenerate"])[pair_snarl]
    assert (~deg).any()
    _hold(res, base, deg, ("p", "beta"))
    single = _one_device(design, pair_snarl, expr)
    for key in KEYS:
        np.testing.assert_array_equal(res[key], single[key], key)


@pytest.mark.parametrize("n", [1, 3, 8, 40])
def test_eqtl_pairs_shard_map_parity(tmp_path, n):
    """eqtl_regress_pairs_sharded matches stoat_tpu's (on its 8-device
    mesh) string for string: 19 pairs, seed 23; 40 ranges leave some
    empty."""
    packed, design, jdesign = _designs(tmp_path, 23)
    rng = np.random.default_rng(1)
    B = 19  # deliberately not a multiple of the device count
    pair_snarl = rng.integers(0, packed.n_snarls, B)
    expr = rng.standard_normal((B, 40))
    want = jpar.eqtl_regress_pairs_sharded(jdesign, pair_snarl, expr,
                                           jpar.make_snarl_mesh())
    res = eqtl_regress_pairs_sharded(design, pair_snarl, np.arange(B), expr,
                                     make_snarl_mesh([CPU] * n))
    _hold(res, want, np.asarray(jdesign["degenerate"])[pair_snarl], KEYS)
    single = _one_device(design, pair_snarl, expr)
    for key in KEYS:
        np.testing.assert_array_equal(res[key], single[key], key)
