"""Command line of the PyTorch/CUDA port: ``stoat vcf`` with a binary trait.

Follows stoat_tpu/cli.py main_vcf (:57-300) for the one mode the port
runs so far: a binary phenotype (chi-squared + Fisher) with no
covariates, on one device.  The snarl paths come from ``-s`` or from the
decomposition of ``-p``/``-d`` (stoat_tpu.graph, reused).  ``--device``
picks the device (default cuda); a CUDA device that is not there is an
error, never a quiet run on the CPU.  Every other mode, subcommand and
flag of stoat_tpu exits non-zero and names ROADMAP.md, where its port is
queued.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import List, Optional

__version__ = "0.3.0"

logger = logging.getLogger("stoat")

_NOT_PORTED = ("is not ported to stoat_tpu_torch yet (see ROADMAP.md, "
               "queue 1); run it with python -m stoat_tpu")

def _check_file(path: str) -> str:
    if not os.path.isfile(path):
        raise SystemExit(f"File {path} does not exist.")
    return path


def _not_ported(what: str) -> int:
    sys.stderr.write(f"Error: [stoat vcf] {what} {_NOT_PORTED}\n")
    return 2


def main_vcf(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m stoat_tpu_torch vcf")
    ap.add_argument("-p", "--graph", metavar="FILE")
    ap.add_argument("-d", "--dist", metavar="FILE")
    ap.add_argument("-v", "--vcf", metavar="FILE")
    ap.add_argument("-s", "--snarl", metavar="FILE")
    ap.add_argument("-b", "--binary", metavar="FILE")
    ap.add_argument("--resume", action="store_true",
                    help="resume an interrupted run: chromosomes already "
                         "checkpointed in <output>.progress are skipped")
    ap.add_argument("-I", "--min-individuals", type=int, default=3)
    ap.add_argument("-H", "--min-haplotypes", type=int, default=5)
    ap.add_argument("-M", "--maf", type=float, default=0.05)
    ap.add_argument("-o", "--output", default="output")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu; "
                         "cuda without a card is an error")
    # every other stoat_tpu vcf flag belongs to a mode not ported yet
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        return _not_ported(f"option {' '.join(unknown)}")
    logging.basicConfig(level=logging.WARNING,
                        format="[%(levelname)s] %(message)s", force=True)

    # threshold validation (stoat_tpu/cli.py:113-128)
    if args.min_individuals < 2:
        raise SystemExit("Error: [stoat vcf] min_individuals threshold "
                         "must be > 1")
    if args.min_haplotypes < 2:
        raise SystemExit("Error: [stoat vcf] min_haplotypes threshold "
                         "must be > 1")
    if not (0 <= args.maf <= 1):
        raise SystemExit("Error: [stoat vcf] MAF must be in [0,1]")
    for path in (args.graph, args.dist, args.vcf, args.snarl, args.binary):
        if path:
            _check_file(path)

    decompose = bool(args.graph) and bool(args.dist)
    if not args.binary:
        if decompose and not args.vcf and not args.snarl:
            return _not_ported("snarl decomposition alone (case 3)")
        return _not_ported("a run without -b (binary phenotype)")
    if not ((args.snarl or decompose) and args.vcf):
        logger.error(
            "[stoat vcf] Invalid argument combination provided.\n"
            "stoat_tpu_torch runs: snarl_path + vcf_path + binary "
            "phenotype, or graph_path + dist_path + vcf_path + binary "
            "phenotype")
        return 1

    from stoat_tpu_torch.device import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"Error: [stoat vcf] {e}") from e

    os.makedirs(args.output, exist_ok=True)
    t_start = time.time()

    from stoat_tpu.io import parse_binary_pheno, parse_snarl_path
    from stoat_tpu.io.vcf import VcfReader

    header_reader = VcfReader(args.vcf)
    list_samples = header_reader.samples
    header_reader.close()
    binary_phenotype, list_samples = parse_binary_pheno(args.binary,
                                                        list_samples)
    if args.snarl:
        snarls_chr = parse_snarl_path(args.snarl)
    else:
        logger.info("Starting snarl decomposition... ")
        t0 = time.time()
        from stoat_tpu.graph import decompose_to_snarl_file
        # stoat_tpu's defaults: all chromosomes, children 50, path length
        # 10000, cycle 1 (the flags that change them are not ported)
        snarls_chr = decompose_to_snarl_file(args.graph, args.dist,
                                             args.output, set())
        logger.info("Snarl time decomposition : %.3f s", time.time() - t0)

    t_gwas = time.time()
    logger.info("Starting GWAS analysis on %s...", device)
    from stoat_tpu_torch.pipeline.runner import run_vcf_analysis
    run_vcf_analysis(
        args.vcf, snarls_chr,
        os.path.join(args.output, "binary_table_vcf.tsv"),
        binary_phenotype, device,
        maf_threshold=args.maf,
        min_individuals=args.min_individuals,
        min_haplotypes=args.min_haplotypes,
        sample_names=list_samples,
        resume=args.resume,
    )
    t_end = time.time()
    logger.info("GWAS time analysis : %.3f s", t_end - t_gwas)
    logger.info("Total time : %.3f s", t_end - t_start)
    return 0


def print_help() -> None:
    sys.stderr.write(
        "usage: python -m stoat_tpu_torch <command> [options]\n\n"
        "commands:\n"
        "  vcf        VCF-based GWAS, binary phenotype (-b) only\n"
        "  version    print version\n\n"
        "The other stoat_tpu commands and modes are not ported yet; see "
        "ROADMAP.md.\n")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print_help()
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "vcf":
        return main_vcf(rest)
    if cmd == "version":
        print(f"stoat-tpu-torch {__version__}")
        return 0
    if cmd in ("-h", "--help", "help"):
        print_help()
        return 0
    if cmd in ("graph", "BHcorrect", "simulate", "truth", "plot"):
        sys.stderr.write(f"Error: the {cmd} subcommand {_NOT_PORTED}\n")
        return 2
    sys.stderr.write(f"unknown command: {cmd}\n")
    print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
