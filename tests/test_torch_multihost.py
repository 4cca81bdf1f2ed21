"""Two processes, each running only the chunks dealt to its own devices
(the counterpart of tests/test_multihost.py for the port).

Two processes started with ``torch.multiprocessing`` (spawn), joined by
``torch.distributed`` over the gloo backend on a free local port, each
deal the chunks of one chromosome over four devices with
``parallel.mesh.steps`` and run the chunks of their own two devices
(``binary_analyze_chromosome``, the runner's chunk call); rank 0 gathers
them with ``gather_object`` and puts them in chunk order.  The gathered
arrays equal the single-process one-device result bitwise, and stoat_tpu's
p strings (tests/test_multihost.py holds stoat_tpu's two-process run to
those).  This adds no feature: it shows that a chunk runs alone.
"""

import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TH = (3, 5, 0.05)
DEVICES = 4
WORLD = 2
CHUNK = 3
KEYS = ("filtered", "keep", "g0", "g1", "p_fisher", "p_chi2")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _load(paths):
    """The port's snarls, matrix and phenotype of the fixture."""
    from stoat_tpu_torch.io.phenotype import parse_binary_pheno
    from stoat_tpu_torch.io.snarl_file import parse_snarl_path
    from stoat_tpu_torch.io.vcf import VcfReader
    from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix

    reader = VcfReader(paths["vcf"])
    _, records = next(iter(reader.chromosome_chunks()))
    matrix = EdgeHaplotypeMatrix(2 * len(reader.samples))
    for rec in records:
        matrix.add_record(rec)
    reader.close()
    pheno, _ = parse_binary_pheno(paths["binary"], list(paths["samples"]))
    return parse_snarl_path(paths["snarl"])["ref"], matrix, pheno


def _worker(rank, port, paths, out_path):
    """One process: the chunks dealt to its two devices of the four,
    gathered on rank 0 in chunk order."""
    import torch.distributed as dist
    from stoat_tpu_torch.parallel import steps
    from stoat_tpu_torch.pipeline.binary import binary_analyze_chromosome
    from stoat_tpu_torch.tables import pack_chromosome_chunks

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        snarls, matrix, pheno = _load(paths)
        per = DEVICES // WORLD
        mine = range(rank * per, (rank + 1) * per)
        devices = [torch.device("cpu", d) for d in range(DEVICES)]
        local = []
        for s, step in enumerate(steps(pack_chromosome_chunks(
                snarls, matrix, CHUNK), devices)):
            for device, packed in step:
                if device.index in mine:
                    res = binary_analyze_chromosome(packed, pheno, *TH,
                                                    torch.device("cpu"))
                    local.append((s * DEVICES + device.index, {
                        key: np.asarray(res[key])[:packed.n_snarls]
                        for key in KEYS}))
        parts = [None] * WORLD if rank == 0 else None
        dist.gather_object(local, parts, dst=0)
        if rank == 0:
            chunks = sorted((c for part in parts for c in part),
                            key=lambda c: c[0])
            assert [i for i, _r in chunks] == list(range(len(chunks)))
            np.savez(out_path, **{key: np.concatenate(
                [r[key] for _i, r in chunks]) for key in KEYS})
    finally:
        dist.destroy_process_group()


def test_two_process_shards_match_one_process(tmp_path):
    import torch.multiprocessing as mp
    from fixtures import make_fixture
    from stoat_tpu.io.phenotype import parse_binary_pheno as j_binary
    from stoat_tpu.io.snarl_file import parse_snarl_path as j_snarls
    from stoat_tpu.io.vcf import VcfReader as JReader
    from stoat_tpu.matrix import EdgeHaplotypeMatrix as JMatrix
    from stoat_tpu.pipeline.binary import binary_analyze_chromosome as j_bin
    from stoat_tpu.tables import pack_chromosome as j_pack
    from stoat_tpu.writer import format_p
    from stoat_tpu_torch.pipeline.binary import binary_analyze_chromosome
    from stoat_tpu_torch.tables import pack_chromosome

    # tests/multihost_worker.py's fixture, written before the processes
    # start
    paths = make_fixture(str(tmp_path / "data"), n_samples=30, n_snarls=16,
                         seed=4)
    out = str(tmp_path / "gathered.npz")
    ctx = mp.spawn(_worker, args=(_free_port(), paths, out), nprocs=WORLD,
                   join=False)
    deadline = time.monotonic() + 180
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "workers did not finish"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    assert not any(proc.is_alive() for proc in ctx.processes)
    assert all(proc.exitcode == 0 for proc in ctx.processes)
    got = np.load(out)

    snarls, matrix, pheno = _load(paths)
    packed = pack_chromosome(snarls, matrix)
    S = packed.n_snarls
    base = binary_analyze_chromosome(packed, pheno, *TH,
                                     torch.device("cpu"))
    for key in KEYS:
        assert got[key].shape[0] == S
        np.testing.assert_array_equal(got[key], np.asarray(base[key])[:S],
                                      key)

    reader = JReader(paths["vcf"])
    _, records = next(iter(reader.chromosome_chunks()))
    jmatrix = JMatrix(2 * len(reader.samples))
    for rec in records:
        jmatrix.add_record(rec)
    jpheno, _ = j_binary(paths["binary"], list(paths["samples"]))
    want = j_bin(j_pack(j_snarls(paths["snarl"])["ref"], jmatrix), jpheno,
                 *TH)
    for key in ("p_chi2", "p_fisher"):
        assert [format_p(v) for v in got[key]] == \
            [format_p(v) for v in np.asarray(want[key])[:S]], key
