"""Readings that the limits of ``correct`` are set from.

    python3 gwasbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9

For each of ``--seeds``: the cell's cohort from the seed, one job of the
program as the window runs it, and the comparison with the reference:
the lower readings.  For each of ``--control-seeds``: the control, the
reference computed in float32 (the precision below the float64 the
configuration states) put in the program's place, its tables compared
with the float64 reference's: the upper readings.  One JSON line a
reading, on the cell's cards of this machine (``harness.cell_device``),
in one process; without a card it exits with no reading.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gwasbench import harness  # noqa: E402


def program_reading(cell, seed: int, device_name: str, workdir: str,
                    control: bool = False):
    """(program readings or None, control readings or None) of one seed."""
    import torch
    device = torch.device(device_name)
    inputs = importlib.import_module(
        f"gwasbench.inputs.{cell.config['inputs']}")
    checker = importlib.import_module(
        f"gwasbench.reference.{cell.traffic['reference']}")
    n_perms = int(cell.traffic["permutations"])
    cohort = inputs.make(cell.config, seed, os.path.join(workdir, "in"))
    out_dir = os.path.join(workdir, "out")
    window = harness.Window()
    t0 = time.perf_counter()
    harness.run_job(harness.job_argv(cell, cohort, out_dir, seed,
                                     device_name), out_dir, window)
    job_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exp = checker.expected(cohort, cell.config, n_perms, seed, device)
    ref_s = time.perf_counter() - t0
    job = window.jobs[0]
    worst = []
    got = (checker.compare(exp, window.outputs[job.digest], cohort, worst)
           if job.error is None else {"error": job.error})
    got["worst"] = worst
    got.update(job_s=job_s, reference_s=ref_s)
    ctrl = None
    if control:
        low = checker.expected(cohort, cell.config, n_perms, seed, device,
                               dtype=torch.float32)
        ctrl = checker.compare(exp, checker.render(low, cohort), cohort)
    return got, ctrl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gwasbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {cell.name} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 3
    device_name = harness.cell_device(cell)
    harness.build_program(torch.device(device_name))
    print(json.dumps({"card": harness.card_note()}), flush=True)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        workdir = tempfile.mkdtemp(prefix="gwasbench-cal-")
        try:
            got, ctrl = program_reading(cell, seed, device_name, workdir,
                                        control=seed in args.control_seeds)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        if seed in args.seeds:
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": "program", **got}), flush=True)
        if ctrl is not None:
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": "control", **ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
