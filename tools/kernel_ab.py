#!/usr/bin/env python3
"""Time a CUDA kernel of the checkout against another version of its source,
on one card, in one process.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/kernel_ab.py --baseline DIR [--candidate DIR]
                               [--kernel ols|perm_ols|quant_design]
                               [--snarls 16384] [--rounds 4]

Each DIR holds one version's kernel sources (its ``<kernel>.cu`` and the
``.cuh`` headers that it includes), for example the ``csrc/`` of an
earlier commit unpacked with ``git archive``; the candidate defaults to the
checkout's ``stoat_tpu_torch/csrc``.  Both versions are built with the
port's nvcc flags (``stoat_tpu_torch/kernels/build.py``) and their ptxas
registers and spills printed.  Both then run through the port's own
wrapper on the same inputs, the first chunk of ``vcf -q -c -C AGE,SEX`` on
chip_smoke.py's cohort (2,504 samples; ``--snarls`` over 2 chromosomes,
8,192 per chunk; perm_ols with the observed phenotype and 64
Freedman-Lane permutations; quant_design's OLS design, ``all_rows`` off,
launched with the argument list each version's source declares), in the
order A B B A for ``--rounds`` rounds (A is the candidate).  It prints each version's ms per call (CUDA events,
the median of its rounds), its device ms per call (torch.profiler) and
whether the two versions' outputs are equal bit for bit, then the card's
name and power limit.  It exits non-zero when there is no card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def quant_chunk(cs, device, snarls, work):
    """The first ``vcf -q -c`` chunk's design, phenotype and covariates."""
    from fixtures import make_fixture
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    paths = make_fixture(os.path.join(work, "data"), n_samples=cs.N_SAMPLES,
                         n_snarls=snarls, seed=0, n_chroms=cs.N_CHROMS)
    chunk, qchunk, qpheno, qcovar, H, case, _ = cs.main_path_chunks(paths,
                                                                    device)
    d = quant_design(qchunk, qcovar, *cs.THRESHOLDS, H)
    return d, chunk, qpheno, qcovar, case


def ols_inputs(cs, device, snarls, work):
    """A zero-argument call of linear_regression_stats on the first
    ``vcf -q -c`` chunk, and its design's shape."""
    from stoat_tpu_torch.stats.linreg import linear_regression_stats
    d, _, qpheno, _, _ = quant_chunk(cs, device, snarls, work)
    args = (d["X"], qpheno[None, :] * d["used"], d["used"], d["ncols"])
    return (lambda: linear_regression_stats(*args)), tuple(d["X"].shape)


def perm_ols_inputs(cs, device, snarls, work):
    """A zero-argument call of perm_ols_stats on the first ``vcf -q -c``
    chunk with 1 + 64 phenotype rows, and the design's shape."""
    from stoat_tpu_torch.pipeline.permutation import perm_ols_stats
    d, chunk, qpheno, qcovar, case = quant_chunk(cs, device, snarls, work)
    rows = cs.perm_host_rows(cs.to_np(case) > 0.5, cs.to_np(qpheno),
                             cs.to_np(qcovar), int(chunk.words.shape[1]), 64)
    args = (d["X"], d["used"], d["ncols"], cs.upload_t(rows["phenos"],
                                                       device))
    return (lambda: perm_ols_stats(*args)), tuple(d["X"].shape)


def quant_design_inputs(cs, device, snarls, work, versions):
    """A zero-argument call of the quant_design kernel on the first ``vcf
    -q -c`` chunk (the OLS design: all_rows off), and X's shape.  The call
    passes ``all_rows`` only to a version whose source declares it
    (``versions``: tag -> source directory), read from the tag that
    ``use`` last set (STATE)."""
    import torch
    from stoat_tpu_torch.kernels import F64, I64, VOIDP, launch
    from stoat_tpu_torch.pipeline.quantitative import DESIGN_KEYS
    d, chunk, _qpheno, qcovar, _case = quant_chunk(cs, device, snarls, work)
    with_flag = {}
    for tag, src in versions.items():
        with open(os.path.join(src, "quant_design.cu")) as fh:
            with_flag[tag] = "all_rows" in fh.read()
    W = int(chunk.words.shape[1])
    K = int(chunk.path_idx.shape[1])
    S, Pmax = chunk.snarl_path_idx.shape
    N, C = qcovar.shape
    H = 2 * N
    out = {key: torch.empty_like(d[key]) for key in DESIGN_KEYS}

    def call():
        ints = [S, Pmax, K, W, N, C, H] + ([0] if with_flag[STATE["tag"]]
                                           else [])
        launch("quant_design",
               [VOIDP] * 11 + [I64] * len(ints) + [F64] * 3,
               [chunk.words.data_ptr(), chunk.path_idx.data_ptr(),
                chunk.path_valid.data_ptr(), chunk.snarl_path_idx.data_ptr(),
                qcovar.data_ptr(), *(out[k].data_ptr() for k in DESIGN_KEYS),
                *ints, *map(float, cs.THRESHOLDS)], device)
        return [out[k] for k in DESIGN_KEYS]
    return call, tuple(d["X"].shape)


CALLS = {"ols": ols_inputs, "perm_ols": perm_ols_inputs,
         "quant_design": quant_design_inputs}
# the version whose library is loaded (kernel_ab's use)
STATE = {"tag": "A"}


def build_version(build, name, src_dir, tag):
    """One version's library, built afresh, and its ptxas report."""
    src = os.path.join(os.path.abspath(src_dir), f"{name}.cu")
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{name}-{tag}.so"
    res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                          str(out), src], capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    return ctypes.CDLL(str(out)), (res.stdout + res.stderr).strip()


def registers(ptxas):
    regs = re.findall(r"Used (\d+) registers", ptxas)
    spills = re.findall(r"(\d+) bytes spill stores", ptxas)
    return f"regs={','.join(regs)} spill_stores={','.join(spills) or '0'}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="directory of the other version's kernel sources")
    ap.add_argument("--candidate",
                    help="directory of the version to test (default: the "
                         "checkout's stoat_tpu_torch/csrc)")
    ap.add_argument("--kernel", default="ols", choices=sorted(CALLS))
    ap.add_argument("--snarls", type=int, default=16384)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("kernel_ab: no CUDA device is available\n")
        return 1
    for path in (HERE, os.path.join(HERE, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import chip_smoke as cs
    from stoat_tpu_torch.kernels import build

    name = args.kernel
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    libs, ptxas = {}, {}
    candidate = args.candidate or build.CSRC_DIR
    for tag, src_dir in (("A", candidate), ("B", args.baseline)):
        libs[tag], ptxas[tag] = build_version(build, name, src_dir, tag)

    def use(tag):
        STATE["tag"] = tag
        with build._LOCK:
            build._LIBS[name] = libs[tag]

    work = tempfile.mkdtemp(prefix="ab-", dir=build.BUILD_DIR)
    extra = ({"versions": {"A": str(candidate), "B": args.baseline}}
             if name == "quant_design" else {})
    try:
        call, shape = CALLS[name](cs, device, args.snarls, work, **extra)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    outs, ms, dev = {}, {"A": [], "B": []}, {}
    for tag in ("A", "B"):
        use(tag)
        outs[tag] = [cs.to_np(t) for t in call()]
    for _ in range(args.rounds):
        for tag in ("A", "B", "B", "A"):
            use(tag)
            ms[tag].append(cs.cuda_ms(call, 10))
    for tag in ("A", "B"):
        use(tag)
        dev[tag] = cs.device_ms(torch, {name: call})[name]
    use("A")
    same = all(cs.same_bits(a, b) for a, b in zip(outs["A"], outs["B"]))
    for tag, what in (("A", candidate), ("B", args.baseline)):
        cs.say(f"{name} {tag} ({what}): {registers(ptxas[tag])}; "
               f"{statistics.median(ms[tag]):.4f} ms per call (median of "
               f"{len(ms[tag])} timings of 10 calls: "
               + ", ".join(f"{t:.4f}" for t in ms[tag])
               + f"); device {dev[tag]} ms per call")
    cs.say(f"{name} on {shape}: outputs of A and B bitwise equal: {same}")
    cs.say(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
