#!/usr/bin/env python3
"""Time a CUDA kernel of the checkout against another version of its source,
on one card, in one process.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/kernel_ab.py --baseline DIR [--candidate DIR ...]
                               [--kernel logreg|ols|perm_ols|quant_design|
                                         score_perm]
                               [--snarls 16384] [--rounds 4]

Each DIR holds one version's kernel sources (its ``<source>.cu`` and the
``.cuh`` headers that it includes; score_perm is in ``score_test.cu``),
for example the ``csrc/`` of an earlier commit unpacked with ``git
archive``; the candidate defaults to the checkout's
``stoat_tpu_torch/csrc``.  Both versions are built with the
port's nvcc flags (``stoat_tpu_torch/kernels/build.py``) and their ptxas
registers and spills printed, and the float64 tensor-core instructions in
each library's SASS (``cuobjdump -sass``, lines with DMMA).  Both then run
through the port's own wrapper on the same inputs, the first chunk of
``vcf -q -c -C AGE,SEX`` on chip_smoke.py's cohort (2,504 samples;
``--snarls`` over 2 chromosomes, 8,192 per chunk; perm_ols with the
observed phenotype and the main path's 1,000 Freedman-Lane permutations
(chip_smoke.PERM_FULL); score_perm on the first ``vcf -b -c`` chunk's D
and V^-1 with the observed residual and 1,000 permuted ones; quant_design's OLS design, ``all_rows`` off
and no table view, launched with the argument list each version's source
declares; logreg on the first ``vcf -b -c`` chunk's design and case
indicator, chip_smoke.py phase 5's ``fit``), in the order A B B A for
``--rounds`` rounds (A is the candidate).  With ``--candidate`` given
more than once, the candidates A1, A2, ... and B run in that order and
back in each round, and each candidate is compared with B.  It prints
each version's ms per call (CUDA events, the median
of its rounds), its device ms per call (torch.profiler), whether the two
versions' outputs are equal bit for bit and, where they are not, the
largest relative difference of the first output (t1, T: |A - B| /
max(|B|, 1); logreg's p in units of max(|B|, 1e-5); chip_smoke.stat_err;
inf unless NaN and infinities agree) and, for logreg, the snarls whose
Newton step counts differ,
then the card's name and power limit.  It exits non-zero when there is no
card.
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
    chunk with 1 + PERM_FULL phenotype rows, and the design's shape."""
    from stoat_tpu_torch.pipeline.permutation import perm_ols_stats
    d, chunk, qpheno, qcovar, case = quant_chunk(cs, device, snarls, work)
    rows = cs.perm_host_rows(cs.to_np(case) > 0.5, cs.to_np(qpheno),
                             cs.to_np(qcovar), int(chunk.words.shape[1]),
                             cs.PERM_FULL)
    args = (d["X"], d["used"], d["ncols"], cs.upload_t(rows["phenos"],
                                                       device))
    return (lambda: perm_ols_stats(*args)), tuple(d["X"].shape)


def score_perm_inputs(cs, device, snarls, work):
    """A zero-argument call of score_perm_stats on the first ``vcf -b -c``
    chunk (its design has no covariates; D and V^-1 from the plain
    score_precompute) with 1 + PERM_FULL residual rows, and D's shape."""
    import torch
    from stoat_tpu_torch.pipeline import permutation as pm
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    _d, chunk, qpheno, qcovar, case = quant_chunk(cs, device, snarls, work)
    no_covar = torch.zeros((qcovar.shape[0], 0), dtype=torch.float64,
                           device=device)
    d = quant_design(chunk, no_covar, *cs.THRESHOLDS, 2 * qcovar.shape[0])
    rows = cs.perm_host_rows(cs.to_np(case) > 0.5, cs.to_np(qpheno),
                             cs.to_np(qcovar), int(chunk.words.shape[1]),
                             cs.PERM_FULL)
    Z, w, e = (cs.upload_t(rows[k], device) for k in ("Z", "w", "e"))
    D, Vinv, _df, _bad = pm.score_precompute_plain(
        d["X"], d["used"], d["ncols"], d["filtered"] | d["degenerate"], Z, w)
    args = (D, d["used"], Vinv, e)
    return (lambda: [pm.score_perm_stats(*args)]), tuple(D.shape)


def logreg_inputs(cs, device, snarls, work):
    """A zero-argument call of logistic_regression on the first ``vcf -b
    -c`` chunk (its design has no covariates, y the case indicator times
    the used rows), and X's shape."""
    import torch
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    from stoat_tpu_torch.stats.logreg import LOGREG_KEYS, logistic_regression
    _d, chunk, _qpheno, qcovar, case = quant_chunk(cs, device, snarls, work)
    no_covar = torch.zeros((qcovar.shape[0], 0), dtype=torch.float64,
                           device=device)
    d = quant_design(chunk, no_covar, *cs.THRESHOLDS, 2 * qcovar.shape[0])
    args = (d["X"], case[None, :] * d["used"], d["used"], d["ncols"],
            d["degenerate"])

    def call():
        out = logistic_regression(*args)
        return [out[k] for k in LOGREG_KEYS]
    return call, tuple(d["X"].shape)


def quant_design_inputs(cs, device, snarls, work, versions):
    """A zero-argument call of the quant_design kernel on the first ``vcf
    -q -c`` chunk (the OLS design: all_rows off, no table view), and X's
    shape.  The call passes ``all_rows`` only to a version whose source
    declares it, and the table view's two (null) output pointers only to
    one that declares kTables (``versions``: tag -> source directory),
    read from the tag that ``use`` last set (STATE)."""
    import torch
    from stoat_tpu_torch.kernels import F64, I64, VOIDP, launch
    from stoat_tpu_torch.pipeline.quantitative import DESIGN_KEYS
    d, chunk, _qpheno, qcovar, _case = quant_chunk(cs, device, snarls, work)
    with_flag, with_tables = {}, {}
    for tag, src in versions.items():
        with open(os.path.join(src, "quant_design.cu")) as fh:
            text = fh.read()
        with_flag[tag] = "all_rows" in text
        with_tables[tag] = "kTables" in text
    W = int(chunk.words.shape[1])
    K = int(chunk.path_idx.shape[1])
    S, Pmax = chunk.snarl_path_idx.shape
    N, C = qcovar.shape
    H = 2 * N
    out = {key: torch.empty_like(d[key]) for key in DESIGN_KEYS}

    def call():
        tag = STATE["tag"]
        ints = [S, Pmax, K, W, N, C, H] + ([0] if with_flag[tag] else [])
        tables = [None, None] if with_tables[tag] else []
        launch("quant_design",
               [VOIDP] * (11 + len(tables)) + [I64] * len(ints) + [F64] * 3,
               [chunk.words.data_ptr(), chunk.path_idx.data_ptr(),
                chunk.path_valid.data_ptr(), chunk.snarl_path_idx.data_ptr(),
                qcovar.data_ptr(), *(out[k].data_ptr() for k in DESIGN_KEYS),
                *tables, *ints, *map(float, cs.THRESHOLDS)], device)
        return [out[k] for k in DESIGN_KEYS]
    return call, tuple(d["X"].shape)


CALLS = {"logreg": logreg_inputs, "ols": ols_inputs, "perm_ols": perm_ols_inputs,
         "quant_design": quant_design_inputs,
         "score_perm": score_perm_inputs}
# the first output's statistic and p floor in chip_smoke.stat_err
FIRST = {"logreg": ("p", 1e-5)}
# the source (and library) of each kernel
SOURCES = {"score_perm": "score_test"}
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
    return ctypes.CDLL(str(out)), (res.stdout + res.stderr).strip(), \
        str(out)


def dmma_count(lib_path):
    """Lines of the library's SASS that hold a float64 tensor-core
    instruction (DMMA)."""
    from stoat_tpu_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        return f"cuobjdump failed: {res.stderr.strip()[:200]}"
    return sum("DMMA" in line for line in res.stdout.splitlines())


def registers(ptxas):
    regs = re.findall(r"Used (\d+) registers", ptxas)
    spills = re.findall(r"(\d+) bytes spill stores", ptxas)
    return f"regs={','.join(regs)} spill_stores={','.join(spills) or '0'}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="directory of the other version's kernel sources")
    ap.add_argument("--candidate", action="append",
                    help="directory of a version to test (default: the "
                         "checkout's stoat_tpu_torch/csrc); repeat it to "
                         "time several versions in turn")
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

    kernel = args.kernel
    name = SOURCES.get(kernel, kernel)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    libs, ptxas, dmma = {}, {}, {}
    candidates = args.candidate or [str(build.CSRC_DIR)]
    sources = {("A" if len(candidates) == 1 else f"A{i + 1}"): str(c)
               for i, c in enumerate(candidates)}
    sources["B"] = args.baseline
    tags = list(sources)
    for tag, src_dir in sources.items():
        libs[tag], ptxas[tag], path = build_version(build, name, src_dir, tag)
        dmma[tag] = dmma_count(path)

    def use(tag):
        STATE["tag"] = tag
        with build._LOCK:
            build._LIBS[name] = libs[tag]

    work = tempfile.mkdtemp(prefix="ab-", dir=build.BUILD_DIR)
    extra = {"versions": sources} if kernel == "quant_design" else {}
    try:
        call, shape = CALLS[kernel](cs, device, args.snarls, work, **extra)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    outs, ms, dev = {}, {tag: [] for tag in tags}, {}
    for tag in tags:
        use(tag)
        outs[tag] = [cs.to_np(t) for t in call()]
    for _ in range(args.rounds):
        for tag in tags + tags[::-1]:
            use(tag)
            ms[tag].append(cs.cuda_ms(call, 10))
    for tag in tags:
        use(tag)
        dev[tag] = cs.device_ms(torch, {kernel: call})[kernel]
    use(tags[0])
    for tag in tags:
        cs.say(f"{kernel} {tag} ({sources[tag]}): {registers(ptxas[tag])}; "
               f"DMMA lines in the SASS: {dmma[tag]}; "
               f"{statistics.median(ms[tag]):.4f} ms per call (median of "
               f"{len(ms[tag])} timings of 10 calls: "
               + ", ".join(f"{t:.4f}" for t in ms[tag])
               + f"); device {dev[tag]} ms per call")
    stat, floor = FIRST.get(kernel, ("t1", 0.0))
    for tag in tags[:-1]:
        same = all(cs.same_bits(a, b) for a, b in zip(outs[tag], outs["B"]))
        first = cs.stat_err(stat, outs[tag][0], outs["B"][0], p_floor=floor)
        flips = ""
        if kernel == "logreg":
            diff = (outs[tag][3] != outs["B"][3]).nonzero()[0].tolist()
            flips = f"; snarls whose Newton step counts differ: {diff}"
        cs.say(f"{kernel} on {shape}: outputs of {tag} and B bitwise equal: "
               f"{same}; largest relative difference of the first output: "
               f"{first:.3g}" + flips)
    cs.say(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
