"""Command line of the PyTorch/CUDA port: ``stoat vcf`` (every
single-device mode, with the permutation test) and ``stoat graph``.

``vcf`` follows stoat_tpu/cli.py main_vcf (:57-356) on one device: a binary
phenotype (``-b``, chi-squared + Fisher; with ``-c FILE -C NAME[,NAME...]``,
IRLS logistic regression, whose model leaves the covariates out as the
reference does), a quantitative phenotype (``-q``, OLS) with or without
covariates, both in one pass (``-b -q``: two tables), the EMMAX mixed model
(``-q -k KINSHIP --lmm``, into ``lmm_table_vcf.tsv``; ``-k`` without
``--lmm`` parses the matrix, warns and runs OLS) and eQTL (``-e EXPR -G
GENES [-w WINDOW]``, one row per snarl and gene within the window).
``--permutations N [--perm-seed S]`` then runs the Westfall–Young min-P
permutation test (pipeline/permutation.py) into
``binary_permutation_vcf.tsv`` and/or ``quantitative_permutation_vcf.tsv``.
The snarl paths come from ``-s`` or from the decomposition of ``-p``/``-d``
(graph/decompose.py).  ``graph`` follows main_graph (:383-411): walk-set
partitions of the graph's haplotype paths, tested against a binary
phenotype.  ``--device`` picks the device (default cuda); a CUDA device
that is not there is an error, never a quiet run on the CPU.  Every other
mode, subcommand and flag of stoat_tpu exits non-zero and names
ROADMAP.md, where its port is queued.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import List, Optional

from stoat_tpu_torch.logsetup import TRACE

__version__ = "0.3.0"

logger = logging.getLogger("stoat")

_NOT_PORTED = ("is not ported to stoat_tpu_torch yet (see ROADMAP.md, "
               "queue 1); run it with python -m stoat_tpu")

_LOG_LEVELS = {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO,
               3: logging.DEBUG, 4: TRACE}


def _setup_logging(verbosity: int) -> None:
    """-V 0..4 (stoat_tpu/cli.py:36-39)."""
    logging.basicConfig(
        level=_LOG_LEVELS.get(verbosity, logging.WARNING),
        format="[%(levelname)s] %(message)s", force=True)


def _set_threads(n: int) -> None:
    """-t/--thread -> the native cores' worker count (stoat_tpu/cli.py:
    49-54); 0 leaves their default (all hardware threads)."""
    if n >= 1:
        os.environ["STOAT_THREADS"] = str(n)


def _resolve(device: str, command: str):
    """The torch device, or exit naming why (before any output)."""
    from stoat_tpu_torch.device import resolve_device
    try:
        return resolve_device(device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"Error: [stoat {command}] {e}") from e


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
    ap.add_argument("-q", "--quantitative", metavar="FILE")
    ap.add_argument("-e", "--eqtl", metavar="FILE")
    ap.add_argument("-c", "--covariate", metavar="FILE")
    ap.add_argument("-C", "--covar-name", metavar="NAME")
    ap.add_argument("-k", "--kinship", metavar="FILE")
    ap.add_argument("--permutations", type=int, default=0, metavar="N",
                    help="run an N-permutation Westfall-Young min-P test "
                         "after the GWAS (empirical + FWER p-values into "
                         "{binary,quantitative}_permutation_vcf.tsv; chi2 "
                         "for -b, OLS t for -q, and with -c a "
                         "covariate-adjusted score test for -b / "
                         "Freedman-Lane for -q)")
    ap.add_argument("--perm-seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume an interrupted run: chromosomes already "
                         "checkpointed in <output>.progress are skipped")
    ap.add_argument("--lmm", action="store_true",
                    help="kinship mixed model (EMMAX) for quantitative "
                         "traits; requires -k and -q")
    ap.add_argument("-I", "--min-individuals", type=int, default=3)
    ap.add_argument("-H", "--min-haplotypes", type=int, default=5)
    ap.add_argument("-G", "--gene-position", metavar="FILE")
    ap.add_argument("-w", "--windows-gene", type=int, default=1000000)
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
    if args.windows_gene < 1:
        raise SystemExit("Error: [stoat vcf] Windows gene threshold must "
                         "be > 0")
    if not (0 <= args.maf <= 1):
        raise SystemExit("Error: [stoat vcf] MAF must be in [0,1]")
    for path in (args.graph, args.dist, args.vcf, args.snarl, args.binary,
                 args.quantitative, args.eqtl, args.covariate, args.kinship,
                 args.gene_position):
        if path:
            _check_file(path)

    # stoat_tpu/cli.py:136-169
    covar_names = args.covar_name.split(",") if args.covar_name else []
    if args.covariate and not covar_names:
        logger.error("[stoat vcf] If --covariate path is provided you must "
                     "add the column name(s), using --covar-name")
        return 1
    if bool(args.eqtl) != bool(args.gene_position):
        logger.error("[stoat vcf] eqtl phenotype file and gene position "
                     "file must be provided together")
        return 1
    phenotype_count = sum(bool(p) for p in
                          (args.binary, args.quantitative, args.eqtl))
    decompose = bool(args.graph) and bool(args.dist)
    # -b and -q together run both analyses in one pass (stoat_tpu's
    # extension: one VCF ingest, one K1 pass per chunk, two tables)
    both_phenotypes = bool(args.binary) and bool(args.quantitative) \
        and not args.eqtl
    if phenotype_count == 0:
        if decompose and not args.vcf and not args.snarl:
            return _not_ported("snarl decomposition alone (case 3)")
        return _not_ported("a run without a phenotype")
    if not ((args.snarl or decompose) and args.vcf
            and (phenotype_count == 1 or both_phenotypes)):
        logger.error(
            "[stoat vcf] Invalid argument combination provided.\n"
            "stoat_tpu_torch runs: snarl_path + vcf_path + phenotype, or "
            "graph_path + dist_path + vcf_path + phenotype (phenotype: "
            "-b, -q, both, or -e with -G; each with optional -c/-C)")
        return 1
    # the mixed model's flag rules (stoat_tpu/cli.py:215-242), checked
    # before any output
    if args.lmm and not args.kinship:
        raise SystemExit("Error: [stoat vcf] --lmm requires a kinship "
                         "matrix (-k)")
    if args.lmm and (args.binary or not args.quantitative):
        raise SystemExit("Error: [stoat vcf] --lmm requires a "
                         "quantitative phenotype (-q)")

    device = _resolve(args.device, "vcf")
    os.makedirs(args.output, exist_ok=True)
    t_start = time.time()

    from stoat_tpu_torch.io import (parse_binary_pheno, parse_covariates,
                                    parse_kinship_matrix,
                                    parse_qtl_gene_file,
                                    parse_quantitative_pheno,
                                    parse_snarl_path)
    from stoat_tpu_torch.io.vcf import VcfReader

    header_reader = VcfReader(args.vcf)
    list_samples = header_reader.samples
    header_reader.close()
    covariate = None
    if args.covariate:
        covariate = parse_covariates(args.covariate, covar_names,
                                     list_samples)
    binary_phenotype = quantitative_phenotype = None
    if args.binary:
        # -b -c: the covariates are parsed and validated above, and then
        # stay out of the logistic model (stoat_tpu/stats/logreg.py:9-14)
        mode = "binary_covar" if covariate is not None else "binary"
        binary_phenotype, list_samples = parse_binary_pheno(args.binary,
                                                            list_samples)
        phenotype = binary_phenotype
    if args.quantitative:
        quantitative_phenotype = parse_quantitative_pheno(
            args.quantitative, list_samples)
        if not args.binary:
            mode, phenotype = "quantitative", quantitative_phenotype
    elif args.eqtl:
        mode = "eqtl"
        phenotype = parse_qtl_gene_file(args.eqtl, args.gene_position,
                                        list_samples)

    if args.kinship:
        t0 = time.time()
        kin = parse_kinship_matrix(args.kinship)
        logger.info("Kinship parse : %.3f s", time.time() - t0)
        if args.lmm:
            phenotype = _lmm_null_model(kin, list_samples,
                                        quantitative_phenotype, covariate)
            mode = "lmm"
        else:
            logger.warning("Kinship matrix parsed but unused (parity with "
                           "the reference stub, stats_test.hpp:115-125). "
                           "Pass --lmm with -q to run the mixed model.")

    if args.snarl:
        snarls_chr = parse_snarl_path(args.snarl)
    else:
        logger.info("Starting snarl decomposition... ")
        t0 = time.time()
        from stoat_tpu_torch.graph.decompose import decompose_to_snarl_file
        # stoat_tpu's defaults: all chromosomes, children 50, path length
        # 10000, cycle 1 (the flags that change them are not ported)
        snarls_chr = decompose_to_snarl_file(args.graph, args.dist,
                                             args.output, set())
        logger.info("Snarl time decomposition : %.3f s", time.time() - t0)

    t_gwas = time.time()
    logger.info("Starting GWAS analysis on %s...", device)
    table = {"binary": "binary_table_vcf.tsv",
             "binary_covar": "binary_table_vcf.tsv",
             "quantitative": "quantitative_table_vcf.tsv",
             "lmm": "lmm_table_vcf.tsv",
             "eqtl": "eqtl_table_vcf.tsv"}[mode]
    output_tsv = os.path.join(args.output, table)
    secondary = None
    if both_phenotypes:
        secondary = {"mode": "quantitative",
                     "output_tsv": os.path.join(args.output,
                                                "quantitative_table_vcf.tsv"),
                     "quantitative_phenotype": quantitative_phenotype}
        logger.info("Dual-phenotype run: binary -> %s, quantitative -> %s",
                    output_tsv, secondary["output_tsv"])
    from stoat_tpu_torch.pipeline.runner import run_vcf_analysis
    run_vcf_analysis(
        args.vcf, snarls_chr, output_tsv, phenotype, device, mode=mode,
        covariate=covariate, maf_threshold=args.maf,
        min_individuals=args.min_individuals,
        min_haplotypes=args.min_haplotypes,
        windows_gene_threshold=args.windows_gene,
        sample_names=list_samples, secondary=secondary,
        resume=args.resume,
    )
    if args.permutations > 0 and mode == "eqtl":
        logger.warning("--permutations: eQTL mode has no eligible "
                       "phenotype (binary/quantitative only); skipping.")
    elif args.permutations > 0:
        _permutations(args, snarls_chr, binary_phenotype,
                      quantitative_phenotype, covariate, mode == "lmm",
                      device)
    t_end = time.time()
    logger.info("GWAS time analysis : %.3f s", t_end - t_gwas)
    logger.info("Total time : %.3f s", t_end - t_start)
    return 0


def _lmm_null_model(kin, list_samples, quantitative_phenotype, covariate):
    """The kinship ordered to the samples and the REML null model
    (stoat_tpu/cli.py:222-234)."""
    import numpy as np
    from stoat_tpu_torch.stats.lmm import fit_null_reml
    missing = [s for s in list_samples if s not in kin.ids]
    if missing:
        raise SystemExit(f"Error: [stoat vcf] kinship matrix is missing "
                         f"samples: {missing[:5]}...")
    index = {s: i for i, s in enumerate(kin.ids)}
    order = [index[s] for s in list_samples]
    t0 = time.time()
    ctx = fit_null_reml(quantitative_phenotype,
                        kin.matrix[np.ix_(order, order)], covariate)
    logger.info("LMM null model: delta=%.4g sg2=%.4g se2=%.4g h2=%.3f "
                "REML=%.3f (%.3f s)", ctx.delta, ctx.sigma_g2, ctx.sigma_e2,
                ctx.heritability, ctx.loglik, time.time() - t0)
    return ctx


def _permutations(args, snarls_chr, binary_phenotype, quantitative_phenotype,
                  covariate, lmm: bool, device) -> None:
    """The permutation pass over every phenotype of the run
    (stoat_tpu/cli.py:302-335)."""
    from stoat_tpu_torch.pipeline.permutation import run_permutation_test
    if covariate is not None and binary_phenotype is not None:
        logger.info(
            "--permutations: binary + covariates runs the "
            "covariate-ADJUSTED score test (reduced-model residual "
            "permutation) — P_ASY is the adjusted score-test p, not "
            "the covariate-free Wald p of the main table "
            "(the reference's logistic ignores covariates, "
            "stats_test.cpp:59-62).")
    if lmm:
        logger.warning(
            "--permutations: the permuted statistic is plain OLS — "
            "kinship is NOT modeled, so the permutation P_ASY will "
            "differ from the LMM table's p-values and the FWER "
            "applies to the unrelated-sample analysis only.")
    run_permutation_test(
        args.vcf, snarls_chr,
        output_tsv=(os.path.join(args.output, "binary_permutation_vcf.tsv")
                    if binary_phenotype is not None else None),
        pheno_bin=binary_phenotype,
        quantitative_phenotype=quantitative_phenotype,
        output_tsv_quant=(os.path.join(
            args.output, "quantitative_permutation_vcf.tsv")
            if quantitative_phenotype is not None else None),
        n_perms=args.permutations, seed=args.perm_seed,
        min_individuals=args.min_individuals,
        min_haplotypes=args.min_haplotypes,
        maf_threshold=args.maf, covariate=covariate, device=device)


def main_graph(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m stoat_tpu_torch graph")
    ap.add_argument("-p", "--graph", required=True)
    ap.add_argument("-d", "--dist", required=True)
    ap.add_argument("-b", "--binary", required=True)
    ap.add_argument("-T", "--test", dest="test_method", default="chi2",
                    choices=["exact", "chi2"])
    ap.add_argument("-O", "--output-format", default="tsv",
                    choices=["tsv", "fasta"])
    ap.add_argument("-l", "--allele-size-limit", type=int, default=0)
    ap.add_argument("-r", "--reference-sample", default="")
    ap.add_argument("-t", "--thread", type=int, default=0,
                    help="native-core worker threads (0 = all cores)")
    ap.add_argument("-V", "--verbose", type=int, default=1)
    ap.add_argument("-o", "--output", default="output")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu; "
                         "cuda without a card is an error")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    _set_threads(args.thread)
    for path in (args.graph, args.dist, args.binary):
        _check_file(path)
    device = _resolve(args.device, "graph")
    os.makedirs(args.output, exist_ok=True)

    from stoat_tpu_torch.graph import run_graph_association
    return run_graph_association(
        graph_path=args.graph, dist_path=args.dist,
        binary_path=args.binary, test_method=args.test_method,
        output_format=args.output_format,
        allele_size_limit=args.allele_size_limit,
        reference_sample=args.reference_sample, output_dir=args.output,
        device=device)


def print_help() -> None:
    sys.stderr.write(
        "usage: python -m stoat_tpu_torch <command> [options]\n\n"
        "commands:\n"
        "  vcf        VCF-based GWAS: binary (-b), quantitative (-q),\n"
        "             both, mixed model (-q -k --lmm) or eQTL (-e -G),\n"
        "             each with optional covariates -c/-C\n"
        "  graph      graph-path-based association (binary phenotype)\n"
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
    if cmd == "graph":
        return main_graph(rest)
    if cmd == "version":
        print(f"stoat-tpu-torch {__version__}")
        return 0
    if cmd in ("-h", "--help", "help"):
        print_help()
        return 0
    if cmd in ("BHcorrect", "simulate", "truth", "plot"):
        sys.stderr.write(f"Error: the {cmd} subcommand {_NOT_PORTED}\n")
        return 2
    sys.stderr.write(f"unknown command: {cmd}\n")
    print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
