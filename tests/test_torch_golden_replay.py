"""Replay the reference binary's committed golden output through our
kernels: every row of tests/expected_output/vcf/binary/binary_table_vcf.tsv
carries its contingency table in GROUP_PATHS; feeding those counts to our
chi²/Fisher kernels must reproduce the P_CHI2 / P_FISHER strings the C++
binary printed.  This is numerics parity against ~700 rows of genuine
reference output (not synthetic oracles).

The JAX suite's test (tests/test_golden_replay.py) on the port's
statistics on CPU tensors, each value also held to ``stoat_tpu``'s
(tests/test_torch_stats_oracle.py's wrappers).  It skips, as the JAX
suite's does, where the reference's goldens are not mounted."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from stoat_tpu_torch.writer import format_p

from test_golden_replay import GOLDEN
from test_torch_stats_oracle import chi2_2x2, chi2_2xn, fisher_exact_2x2

pytestmark = pytest.mark.skipif(not os.path.exists(GOLDEN),
                                reason="reference goldens unavailable")


def load_rows():
    rows = []
    with open(GOLDEN) as fh:
        fh.readline()
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 9:
                continue
            pairs = [tuple(map(int, t.split(":")))
                     for t in cols[7].split(",")]
            rows.append((cols[3], cols[5], cols[6], pairs))
    return rows


def test_replay_all_golden_binary_rows():
    rows = load_rows()
    assert len(rows) > 500

    two = [(sid, pf, pc, p) for sid, pf, pc, p in rows if len(p) == 2]
    many = [(sid, pf, pc, p) for sid, pf, pc, p in rows if len(p) > 2]

    # 2x2 rows: both tests, exact string parity
    g0 = np.array([[a for a, _ in p] for _, _, _, p in two], float)
    g1 = np.array([[b for _, b in p] for _, _, _, p in two], float)
    chi = np.asarray(chi2_2x2(g0[:, 0], g0[:, 1], g1[:, 0], g1[:, 1]))
    fis = np.asarray(fisher_exact_2x2(g0[:, 0], g0[:, 1], g1[:, 0],
                                      g1[:, 1]))
    mism = []
    for i, (sid, pf, pc, _) in enumerate(two):
        if format_p(chi[i]) != pc:
            mism.append((sid, "chi2", pc, format_p(chi[i])))
        if format_p(fis[i]) != pf:
            mism.append((sid, "fisher", pf, format_p(fis[i])))
    assert not mism, f"{len(mism)} mismatches, first 10: {mism[:10]}"

    # 2xN rows: chi2 only (Fisher is NA by contract)
    if many:
        pmax = max(len(p) for _, _, _, p in many)
        G0 = np.zeros((len(many), pmax))
        G1 = np.zeros((len(many), pmax))
        mask = np.zeros((len(many), pmax), bool)
        for i, (_, _, _, p) in enumerate(many):
            for j, (a, b) in enumerate(p):
                G0[i, j] = a
                G1[i, j] = b
                mask[i, j] = True
        chin = np.asarray(chi2_2xn(G0, G1, mask))
        mism = []
        for i, (sid, pf, pc, _) in enumerate(many):
            if format_p(chin[i]) != pc:
                mism.append((sid, pc, format_p(chin[i])))
            if pf != "NA":
                mism.append((sid, "fisher-should-be-NA", pf))
        assert not mism, mism[:10]
    print(f"replayed {len(two)} 2x2 + {len(many)} 2xN golden rows")
