"""The benchmark of stoat_tpu_torch: whole ``vcf`` jobs, timed.

One process runs one cell once (``run.py``).  Everything a cell is made
of is found by name from ``BENCHMARK.json``: its configuration
(``configs/<config>.json``, which names the input maker under
``inputs/``), its traffic (``traffic/<traffic>.json``: the job's argv,
the permutation count, the reference that checks it), the limits of its
comparison (``limits/<workload>.json``), a reader per per-layer metric
(``metrics/<metric>.py``) and the operations and bytes of each kernel
(``roofline/<kernel>.py``).  A cell added later brings files and entries;
this code does not change.

Set-up: the kernels and native cores built or loaded (cached under
``build/stoat_tpu_torch/`` in the checkout), the cohort written from the
seed into a directory under ``TMPDIR``, one warm-up job.  The window:
jobs, each ``stoat_tpu_torch.cli.main(["vcf", ...])`` in this process,
input files in and both TSVs out, until ``--seconds`` have passed; the
job running then is finished and counted.  Each job's tables are read
back and its output directory removed.  After the window the process
holds no module of JAX or of the JAX package, the reference works out
what the tables must say, and every distinct output is compared with it.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gwasbench")

# modules that no run may hold: JAX and the JAX package beside the port,
# compared by whole top-level names (stoat_tpu_torch starts with stoat_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "stoat_tpu", "bench", "chip_smoke")


class ForbiddenModules(RuntimeError):
    pass


def process_age() -> float:
    """Seconds since this process started (/proc), the clock of
    ``setup_s``."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()


def forbidden_loaded() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------ the cell

@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload: str, overrides: Optional[Dict] = None) -> Cell:
    """The cell named ``workload`` in BENCHMARK.json, its files found by
    name; ``overrides`` replaces configuration keys (tests run tiny
    cohorts)."""
    manifest = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = dict(_json(os.path.join(ROOT, conf["file"])), **(overrides or {}))
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    if overrides and "permutations" in overrides:
        traffic = dict(traffic, permutations=overrides["permutations"])
    limits = _json(os.path.join(HERE, "limits", f"{workload}.json"))["limits"]

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [m for m in manifest["end_to_end"] if mine(m)],
                [m for m in manifest["per_layer"] if mine(m)])


def cell_device(cell: Cell) -> str:
    """The program's ``--device`` for the cell's chips: one card by its
    index, or a bare ``cuda``, which makes a mesh over every visible card
    (``parallel/mesh.py resolve_mesh``)."""
    return "cuda:0" if cell.chips == 1 else "cuda"


def devices_used(device_name: str) -> int:
    import torch
    if device_name == "cuda":
        return torch.cuda.device_count()
    return 1


def job_argv(cell: Cell, cohort, out_dir: str, seed: int,
             device: str) -> List[str]:
    """The traffic's argv with its placeholders filled."""
    config = cell.config
    fill = dict(cohort.paths, out=out_dir, seed=str(seed),
                permutations=str(cell.traffic["permutations"]),
                trait_flag=config["trait_flag"],
                trait=cohort.paths[config["trait"]],
                covar_names=",".join(config["covariate_names"]))
    return [a.format(**fill) for a in cell.traffic["argv"]] + \
        ["--device", device]


def read_outputs(out_dir: str) -> Dict[str, bytes]:
    out = {}
    for name in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, name)
        if name.endswith(".tsv") and os.path.isfile(path):
            with open(path, "rb") as fh:
                out[name] = fh.read()
    return out


def count_tests(tables: Dict[str, bytes], n_perms: int) -> int:
    """Snarl-tests a job reported: a main-table row with a p-value (P,
    or P_CHI2 / P_FISHER) counts 1, a permutation-table row with P_ASY
    counts 1 + K."""
    total = 0
    for data in tables.values():
        lines = data.decode().split("\n")
        header = lines[0].split("\t")
        for col, weight in (("P_ASY", 1 + n_perms), ("P", 1),
                            ("P_CHI2", 1), ("P_FISHER", 1)):
            if col in header:
                i = header.index(col)
                total += weight * sum(
                    1 for line in lines[1:]
                    if line and line.split("\t")[i] != "NA")
                break
    return total


# ------------------------------------------------------------ a run

@dataclass
class Job:
    seconds: float
    digest: Optional[str]
    error: Optional[str] = None


@dataclass
class Window:
    jobs: List[Job] = field(default_factory=list)
    outputs: Dict[str, Dict[str, bytes]] = field(default_factory=dict)
    seconds: float = 0.0


def run_job(argv: List[str], out_dir: str, window: Window, tracer=None):
    """One job: the CLI in this process, then its tables read back and
    its output directory removed."""
    from stoat_tpu_torch import cli
    t0 = time.perf_counter()
    error = None
    try:
        with tracer.span("job") if tracer else nullcontext():
            rc = cli.main(argv)
        if rc != 0:
            error = f"exit code {rc}"
    except SystemExit as e:              # the CLI exits on bad input
        error = f"SystemExit {e.code}"
    except Exception:                    # a failed job is counted, not fatal
        error = traceback.format_exc(limit=3)
    seconds = time.perf_counter() - t0
    digest = None
    if error is None and os.path.isdir(out_dir):
        tables = read_outputs(out_dir)
        h = hashlib.sha256()
        for name, data in tables.items():
            h.update(name.encode() + b"\0" + data)
        digest = h.hexdigest()
        window.outputs.setdefault(digest, tables)
    shutil.rmtree(out_dir, ignore_errors=True)
    window.jobs.append(Job(seconds, digest, error))


def build_program(device) -> None:
    """Build or load every kernel library and the native cores (cached
    under build/stoat_tpu_torch/ in the checkout)."""
    from stoat_tpu_torch import native
    if native.get_lib() is None:
        # the jobs would ingest through the Python reader: another path
        raise RuntimeError("the native VCF core did not build")
    if device.type == "cuda":
        from stoat_tpu_torch.kernels import build
        sources = sorted(f[:-3] for f in os.listdir(
            os.path.join(ROOT, "stoat_tpu_torch", "csrc"))
            if f.endswith(".cu"))
        build.build_all(sources)
        for name in sources:
            build.load(name)


def card_note() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout else \
            "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device_name: Optional[str] = None, log=None) -> Dict:
    """One run of ``cell``: set-up, the window, the check.  Returns the
    result's fields (``checks`` last); raises ForbiddenModules when a
    module of FORBIDDEN is loaded once the window has closed.  The device
    is the cell's (:func:`cell_device`); tests pass ``cpu``."""
    import torch
    from gwasbench import tracing
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    device_name = device_name or cell_device(cell)
    device = torch.device(device_name)
    on_card = device.type == "cuda"
    inputs = importlib.import_module(
        f"gwasbench.inputs.{cell.config['inputs']}")
    workdir = tempfile.mkdtemp(prefix="gwasbench-")
    try:
        if on_card:
            torch.cuda.init()
        build_program(device)
        t0 = time.perf_counter()
        cohort = inputs.make(cell.config, seed, os.path.join(workdir, "in"))
        log(f"cohort: {cohort.n_samples} samples x {cohort.n_snarls} "
            f"snarls, {time.perf_counter() - t0:.3f} s")
        out_dir = os.path.join(workdir, "out")
        argv = job_argv(cell, cohort, out_dir, seed, device_name)
        warm = Window()
        run_job(argv, out_dir, warm)
        if warm.jobs[0].error:
            raise RuntimeError(f"warm-up job failed: {warm.jobs[0].error}")
        del warm
        if on_card:
            for i in range(devices_used(device_name)):
                torch.cuda.synchronize(i)
                torch.cuda.reset_peak_memory_stats(i)
        gc.collect()

        tracer = tracing.Tracer(on_card) if trace else None
        window = Window()
        setup_s = process_age()
        with tracer.window() if tracer else nullcontext():
            start = time.perf_counter()
            while True:
                run_job(argv, out_dir, window, tracer)
                if time.perf_counter() - start >= seconds:
                    break
            if on_card:
                for i in range(devices_used(device_name)):
                    torch.cuda.synchronize(i)
            window.seconds = time.perf_counter() - start
        peak = max((torch.cuda.max_memory_allocated(i)
                    for i in range(devices_used(device_name))),
                   default=0) if on_card else 0
        found = forbidden_loaded()
        if found:
            raise ForbiddenModules(", ".join(found))

        n_perms = int(cell.traffic["permutations"])
        tests = {d: count_tests(t, n_perms)
                 for d, t in window.outputs.items()}
        done = [j for j in window.jobs if j.error is None]
        metrics = {}
        if not trace:
            values = {"snarl_tests_per_s": sum(tests[j.digest] for j in done)
                      / window.seconds, "setup_s": setup_s}
            for m in cell.end_to_end:
                if m["name"] in values:
                    metrics[m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
        smi = card_note() if on_card else "cpu"
        device_out = {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if on_card else "cpu"),
                      "count": devices_used(device_name) if on_card else 1,
                      "memory_peak_bytes": int(peak)}
        breakdown = None
        if tracer:
            ctx = tracer.context(len(window.jobs), peak, smi)
            for m in cell.per_layer:
                reader = importlib.import_module(
                    f"gwasbench.metrics.{m['name']}")
                value = reader.read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            for line in ctx.notes:
                log(line)
            if ctx.busy_s is not None:
                device_out["busy_s"] = ctx.busy_s
                device_out["window_s"] = ctx.window_s
            breakdown = ctx.breakdown()
        for j in window.jobs:
            log(f"job {j.seconds:.3f} s" + (f" FAILED {j.error}"
                                            if j.error else ""))
        log(f"card: {smi}; setup {setup_s:.3f} s; window "
            f"{window.seconds:.3f} s; {len(done)} jobs; peak {peak} bytes")

        # the check: program state freed, the reference after the window
        del tracer
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        checker = importlib.import_module(
            f"gwasbench.reference.{cell.traffic['reference']}")
        exp = checker.expected(cohort, cell.config, n_perms, seed, device)
        found: Dict[str, float] = {}
        worst: List[str] = []
        for tables in window.outputs.values():
            for k, v in checker.compare(exp, tables, cohort, worst).items():
                found[k] = max(found.get(k, v), v)
        for line in worst[:12]:
            log(f"worst {line}")
        log(f"reference and comparison: {time.perf_counter() - t0:.3f} s")
        # a number that could not be read (no output, no finite gap) is
        # printed as the largest double, so that the line stays JSON
        checks = {k: {"value": min(float(found.get(k, math.inf)),
                                   sys.float_info.max),
                      "limit": cell.limits[k]} for k in cell.limits}
        missing = len(window.jobs) - len(done)
        correct = bool(done) and missing == 0 and all(
            c["value"] <= c["limit"] for c in checks.values())
        result = {"correct": correct, "attempted": len(window.jobs),
                  "failed": missing, "metrics": metrics,
                  "device": device_out}
        if breakdown:
            result["breakdown"] = breakdown
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="gwasbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"gwasbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible. No result.", file=sys.stderr)
        return 3
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        print(f"gwasbench: modules of JAX or the JAX package loaded: {e}. "
              f"No result.", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
