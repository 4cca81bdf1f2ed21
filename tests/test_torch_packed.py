"""Parity of the port's packed membership (K1+K2) with the JAX package.

The same numpy inputs, made from a seed, go through stoat_tpu's
``membership_words`` + ``packed_binary_counts`` (XLA on the CPU) and the
port's ``membership_counts`` (its plain PyTorch version on the CPU).
Counts are integers: they must agree exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from stoat_tpu.pipeline import packed as jpk
from stoat_tpu_torch.pipeline import packed as tpk


def _random_case(seed, E=37, H=101, P=23, max_k=5):
    rng = np.random.default_rng(seed)
    matrix = rng.random((E, H)) < 0.6
    valid = rng.random(P) < 0.85
    coo_path, coo_row = [], []
    for p in range(P):
        for _ in range(rng.integers(0, max_k + 1)):
            coo_path.append(p)
            coo_row.append(rng.integers(0, E))
    coo_path = np.array(coo_path, np.int32)
    coo_row = np.array(coo_row, np.int32)
    order = rng.permutation(coo_path.shape[0])
    pheno = rng.random(H) < 0.5
    return matrix, coo_path[order], coo_row[order], valid, pheno


def _jax_counts(words, idx, valid, tail, g1w):
    mem = jpk.membership_words(jnp.asarray(words), jnp.asarray(idx))
    g0, g1 = jpk.packed_binary_counts(mem, jnp.asarray(valid),
                                      jnp.asarray(tail), jnp.asarray(g1w))
    return np.asarray(g0), np.asarray(g1)


def _torch_counts(words, idx, valid, tail, g1w):
    g0, g1 = tpk.membership_counts(
        torch.from_numpy(words.view(np.int32).copy()),
        torch.from_numpy(idx.copy()), torch.from_numpy(valid.copy()),
        torch.from_numpy(tail.view(np.int32).copy()),
        torch.from_numpy(g1w.view(np.int32).copy()))
    assert g0.dtype == g1.dtype == torch.float64
    return g0.numpy(), g1.numpy()


@pytest.mark.parametrize("seed,H", [(0, 101), (1, 96), (2, 7), (3, 32),
                                    (4, 513), (5, 31)])
def test_membership_counts_match_jax(seed, H):
    """Random matrices; H not a multiple of 32, exactly 32 (W=1), and
    one word short of full (tail bits)."""
    matrix, coo_path, coo_row, valid, pheno = _random_case(seed, H=H)
    E = matrix.shape[0]
    words = tpk.pack_matrix_words(matrix)
    idx = tpk.pack_path_edge_idx(coo_path, coo_row, valid, E)
    W = words.shape[1]
    tail = tpk.tail_mask_words(H, W)
    g1w = tpk.pack_hap_mask_words(pheno, W)
    want = _jax_counts(words, idx, valid, tail, g1w)
    got = _torch_counts(words, idx, valid, tail, g1w)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_zero_edge_and_invalid_paths():
    """A valid path with no edges matches every haplotype (vacuous AND);
    an invalid path matches none (test_packed_membership.py:66)."""
    H = 10
    matrix = np.zeros((3, H), bool)
    valid = np.array([True, False])
    empty = np.zeros(0, np.int32)
    words = tpk.pack_matrix_words(matrix)
    idx = tpk.pack_path_edge_idx(empty, empty, valid, 3)
    tail = tpk.tail_mask_words(H, 1)
    pheno = np.zeros(H, bool)
    pheno[:3] = True
    g1w = tpk.pack_hap_mask_words(pheno, 1)
    want = _jax_counts(words, idx, valid, tail, g1w)
    got = _torch_counts(words, idx, valid, tail, g1w)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].tolist() == [7.0, 0.0] and got[1].tolist() == [3.0, 0.0]


def test_sign_bit_words_count_32():
    """Words with the top bit set are negative as int32; the plain
    popcount must still count 32 bits per full word."""
    words = np.full((2, 3), 0xFFFFFFFF, np.uint32)
    idx = np.array([[0, 1], [1, 1]], np.int32)
    valid = np.array([True, True])
    tail = np.full(3, 0xFFFFFFFF, np.uint32)
    g1w = np.array([0x80000000, 0, 0xFFFFFFFF], np.uint32)
    got = _torch_counts(words, idx, valid, tail, g1w)
    want = _jax_counts(words, idx, valid, tail, g1w)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].tolist() == [33.0, 33.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_host_helpers_match_stoat_tpu(seed):
    """The port's copies of the numpy packing helpers give the JAX
    package's arrays bit for bit."""
    matrix, coo_path, coo_row, valid, pheno = _random_case(seed, H=77)
    E, H = matrix.shape
    np.testing.assert_array_equal(tpk.pack_matrix_words(matrix),
                                  jpk.pack_matrix_words(matrix))
    np.testing.assert_array_equal(
        tpk.pack_path_edge_idx(coo_path, coo_row, valid, E),
        jpk.pack_path_edge_idx(coo_path, coo_row, valid, E))
    np.testing.assert_array_equal(tpk.pack_hap_mask_words(pheno, 3),
                                  jpk.pack_hap_mask_words(pheno, 3))
    np.testing.assert_array_equal(tpk.tail_mask_words(H, 3),
                                  jpk.tail_mask_words(H, 3))
    words = tpk.pack_matrix_words(matrix)
    np.testing.assert_array_equal(tpk.unpack_words_to_dense(words, H),
                                  jpk.unpack_words_to_dense(words, H))
    assert tpk.unpack_words_to_dense(words[:1], H).shape == (0, H)


def test_to_device_chunk_feeds_both_packages(tmp_path):
    """convert.to_device_chunk turns a PackedChromosome into the tensors
    whose counts equal the JAX package's on the same numpy arrays, for a
    Python-reader (dense) chromosome."""
    from fixtures import make_fixture
    from stoat_tpu.io.phenotype import parse_binary_pheno
    from stoat_tpu.io.snarl_file import parse_snarl_path
    from stoat_tpu.io.vcf import VcfReader
    from stoat_tpu.matrix import EdgeHaplotypeMatrix
    from stoat_tpu.tables import pack_chromosome
    from stoat_tpu_torch.convert import to_device_chunk

    paths = make_fixture(str(tmp_path), n_samples=45, n_snarls=20, seed=3)
    reader = VcfReader(paths["vcf"])
    _, records = next(iter(reader.chromosome_chunks()))
    matrix = EdgeHaplotypeMatrix(2 * len(paths["samples"]))
    for rec in records:
        matrix.add_record(rec)
    reader.close()
    snarls = parse_snarl_path(paths["snarl"])["ref"]
    pheno, _ = parse_binary_pheno(paths["binary"], list(paths["samples"]))
    packed = pack_chromosome(snarls, matrix)
    assert packed.words is None and packed.path_idx is None

    chunk = to_device_chunk(packed, pheno, torch.device("cpu"))
    assert chunk.words.dtype == torch.int32
    assert chunk.path_idx.dtype == chunk.snarl_path_idx.dtype == torch.int32
    g0, g1 = tpk.membership_counts(chunk.words, chunk.path_idx,
                                   chunk.path_valid, chunk.tail,
                                   chunk.g1_words)
    W = chunk.words.shape[1]
    g1w, tail = jpk.upload_pheno_mask_words(pheno, packed.n_haplotypes, W)
    jg0, jg1 = jpk.packed_binary_counts(
        jpk.membership_words(jnp.asarray(packed.packed_words()),
                             jnp.asarray(packed.path_edge_idx())),
        jnp.asarray(packed.path_valid), tail, g1w)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(jg0))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(jg1))
