"""Command line of the PyTorch/CUDA port: ``stoat vcf`` (every mode, with
the permutation test, the ``-T`` regression tables and the decomposition
alone) and ``stoat graph``.

``vcf`` follows stoat_tpu/cli.py main_vcf (:57-356): a binary
phenotype (``-b``, chi-squared + Fisher; with ``-c FILE -C NAME[,NAME...]``,
IRLS logistic regression, whose model leaves the covariates out as the
reference does), a quantitative phenotype (``-q``, OLS) with or without
covariates, both in one pass (``-b -q``: two tables), the EMMAX mixed model
(``-q -k KINSHIP --lmm``, into ``lmm_table_vcf.tsv``; ``-k`` without
``--lmm`` parses the matrix, warns and runs OLS) and eQTL (``-e EXPR -G
GENES [-w WINDOW]``, one row per snarl and gene within the window).
``-T P`` writes each significant snarl's sample x path table into
``<out>/regression/`` (the regression modes).  ``--permutations N
[--perm-seed S]`` then runs the Westfall–Young min-P permutation test
(pipeline/permutation.py) into ``binary_permutation_vcf.tsv`` and/or
``quantitative_permutation_vcf.tsv``.  The snarl paths come from ``-s`` or
from the decomposition of ``-p``/``-d`` (graph/decompose.py, with
``-r``/``-i``/``-y``/``-l``); ``-p -d`` alone writes the decomposition and
stops (case 3).  ``graph`` follows main_graph (:383-411): walk-set
partitions of the graph's haplotype paths, tested against a binary
phenotype.  ``--device`` picks the device of the GWAS (default cuda); a
CUDA device that is not there is an error, never a quiet run on the CPU.
``vcf --device cuda`` with more than one visible card splits the snarls
over every card (the mesh, parallel/), as stoat_tpu does over every
device; ``cuda:N`` (or ``CUDA_VISIBLE_DEVICES``) pins one card.
``vcf -g`` (with ``-b`` and a graph ``-p``) writes the GAF files of the
binary table after the GWAS (:mod:`stoat_tpu_torch.gaf`).

The host-only subcommands follow stoat_tpu's and take no ``--device``:
``BHcorrect`` (main_bh_correct, :359-380: Benjamini-Hochberg adjustment of
a results TSV, rewritten in place, and its rows below 1e-5),
``simulate`` and ``truth`` (:414-447: a simulated dataset with its truth
table, and precision and recall of a results TSV against it) and ``plot``
(:463-520: QQ, Manhattan, boxplot, histogram, scatter and report PNGs;
the one command that imports matplotlib).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import List, Optional

from stoat_tpu_torch import trace
from stoat_tpu_torch.logsetup import TRACE

__version__ = "0.3.0"

logger = logging.getLogger("stoat")

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


def _resolve(device: str, command: str, mesh: bool = False):
    """The torch device, or exit naming why (before any output).  With
    ``mesh``, a bare ``cuda`` stays bare: the GWAS then runs on every
    visible card when there are several (parallel/mesh.py
    resolve_mesh)."""
    import torch
    from stoat_tpu_torch.device import resolve_device
    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"Error: [stoat {command}] {e}") from e
    if mesh and dev.type == "cuda" and torch.device(device).index is None:
        return torch.device("cuda")
    return dev


def _check_file(path: str) -> str:
    if not os.path.isfile(path):
        raise SystemExit(f"File {path} does not exist.")
    return path


def _not_ported(options: List[str]) -> int:
    """An option that neither this ``vcf`` nor stoat_tpu's has: refused
    with argparse's exit code, before anything runs."""
    sys.stderr.write(f"Error: [stoat vcf] unrecognized arguments: "
                     f"{' '.join(options)} (stoat_tpu's vcf has no such "
                     f"option either)\n")
    return 2


def main_vcf(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m stoat_tpu_torch vcf")
    ap.add_argument("-p", "--graph", metavar="FILE")
    ap.add_argument("-d", "--dist", metavar="FILE")
    ap.add_argument("-v", "--vcf", metavar="FILE")
    ap.add_argument("-s", "--snarl", metavar="FILE")
    ap.add_argument("-r", "--chr", dest="chr_file", metavar="FILE")
    ap.add_argument("-b", "--binary", metavar="FILE")
    ap.add_argument("-q", "--quantitative", metavar="FILE")
    ap.add_argument("-e", "--eqtl", metavar="FILE")
    # parsed and unused, as in stoat_tpu (the reference never reads it)
    ap.add_argument("-m", "--make-bed", action="store_true")
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
    ap.add_argument("-g", "--gaf", action="store_true")
    ap.add_argument("-I", "--min-individuals", type=int, default=3)
    ap.add_argument("-H", "--min-haplotypes", type=int, default=5)
    ap.add_argument("-i", "--children", type=int, default=50)
    ap.add_argument("-y", "--cycle", type=int, default=1)
    ap.add_argument("-l", "--path-length", type=int, default=10000)
    ap.add_argument("-G", "--gene-position", metavar="FILE")
    ap.add_argument("-w", "--windows-gene", type=int, default=1000000)
    ap.add_argument("-T", "--table-threshold", type=float, default=-1)
    ap.add_argument("-M", "--maf", type=float, default=0.05)
    ap.add_argument("-t", "--thread", type=int, default=0,
                    help="native-core worker threads (0 = all cores)")
    ap.add_argument("-V", "--verbose", type=int, default=1)
    ap.add_argument("-o", "--output", default="output")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the GWAS: cuda (default; every "
                         "visible card when there are several), cuda:N "
                         "or cpu; cuda without a card is an error")
    # an option stoat_tpu's vcf does not have either
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        return _not_ported(unknown)
    _setup_logging(args.verbose)
    _set_threads(args.thread)

    # threshold validation (stoat_tpu/cli.py:113-128)
    if args.min_individuals < 2:
        raise SystemExit("Error: [stoat vcf] min_individuals threshold "
                         "must be > 1")
    if args.min_haplotypes < 2:
        raise SystemExit("Error: [stoat vcf] min_haplotypes threshold "
                         "must be > 1")
    if args.children < 2:
        raise SystemExit("Error: [stoat vcf] Children threshold must be > 1")
    if args.cycle < 1:
        raise SystemExit("Error: [stoat vcf] Cycle threshold must be > 0")
    if args.path_length < 2:
        raise SystemExit("Error: [stoat vcf] Path length threshold must be "
                         "> 1")
    if args.windows_gene < 1:
        raise SystemExit("Error: [stoat vcf] Windows gene threshold must "
                         "be > 0")
    if args.table_threshold != -1 and not (0 < args.table_threshold <= 1):
        raise SystemExit("Error: [stoat vcf] Table threshold must be in "
                         "(0,1]")
    if not (0 <= args.maf <= 1):
        raise SystemExit("Error: [stoat vcf] MAF must be in [0,1]")
    for path in (args.graph, args.dist, args.vcf, args.snarl, args.chr_file,
                 args.binary, args.quantitative, args.eqtl, args.covariate,
                 args.kinship, args.gene_position):
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
    only_snarl_parsing = False
    if ((args.snarl or decompose) and args.vcf
            and (phenotype_count == 1 or both_phenotypes)):
        pass                                       # GWAS (cases 1 and 2)
    elif (decompose and not args.vcf and not args.snarl
          and phenotype_count == 0):
        only_snarl_parsing = True                  # case 3
    else:
        logger.error(
            "[stoat vcf] Invalid argument combination provided.\n"
            "There are only 3 ways to launch stoat vcf:\n"
            "Case 1 (GWAS only): snarl_path + vcf_path + phenotype (+ "
            "optional file)\n"
            "Case 2 (GWAS + snarl path decomposition): graph_path + "
            "dist_path + vcf_path + phenotype (+ optional file)\n"
            "Case 3 (snarl path decomposition): graph_path + dist_path")
        return 1
    if args.gaf and (not args.binary or not args.graph):
        logger.error("[stoat vcf] GAF file can be generated only with binary "
                     "phenotype AND with the graph graph")
        return 1
    # the mixed model's flag rules (stoat_tpu/cli.py:215-242), checked
    # before any output
    if args.lmm and not args.kinship:
        raise SystemExit("Error: [stoat vcf] --lmm requires a kinship "
                         "matrix (-k)")
    if args.lmm and (args.binary or not args.quantitative):
        raise SystemExit("Error: [stoat vcf] --lmm requires a "
                         "quantitative phenotype (-q)")

    # the decomposition alone runs on the host: no device to resolve
    device = (None if only_snarl_parsing
              else _resolve(args.device, "vcf", mesh=True))
    os.makedirs(args.output, exist_ok=True)
    regression_dir = os.path.join(args.output, "regression")
    if args.table_threshold != -1:
        os.makedirs(regression_dir, exist_ok=True)
    t_start = time.time()

    with trace.span("cli.parse"):
        from stoat_tpu_torch.io import (parse_binary_pheno,
                                        parse_chromosome_reference,
                                        parse_covariates, parse_kinship_matrix,
                                        parse_qtl_gene_file,
                                        parse_quantitative_pheno,
                                        parse_snarl_path)
        from stoat_tpu_torch.io.vcf import VcfReader

        list_samples: List[str] = []
        if not only_snarl_parsing:
            header_reader = VcfReader(args.vcf)
            list_samples = header_reader.samples
            header_reader.close()
        covariate = None
        if args.covariate:
            covariate = parse_covariates(args.covariate, covar_names,
                                         list_samples)
        binary_phenotype = quantitative_phenotype = None
        mode = phenotype = None
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

        ref_chr = (parse_chromosome_reference(args.chr_file)
                   if args.chr_file else set())
        snarls_chr = parse_snarl_path(args.snarl) if args.snarl else None
    if snarls_chr is None:
        logger.info("Starting snarl decomposition... ")
        t0 = time.time()
        from stoat_tpu_torch.graph.decompose import decompose_to_snarl_file
        snarls_chr = decompose_to_snarl_file(
            args.graph, args.dist, args.output, ref_chr,
            children_threshold=args.children,
            path_length_threshold=args.path_length,
            cycle_threshold=args.cycle)
        logger.info("Snarl time decomposition : %.3f s", time.time() - t0)
        if only_snarl_parsing:
            return 0

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
        table_threshold=args.table_threshold,
        min_individuals=args.min_individuals,
        min_haplotypes=args.min_haplotypes,
        windows_gene_threshold=args.windows_gene,
        regression_dir=regression_dir, sample_names=list_samples,
        secondary=secondary, resume=args.resume,
    )
    if args.permutations > 0 and mode == "eqtl":
        logger.warning("--permutations: eQTL mode has no eligible "
                       "phenotype (binary/quantitative only); skipping.")
    elif args.permutations > 0:
        _permutations(args, snarls_chr, binary_phenotype,
                      quantitative_phenotype, covariate, mode == "lmm",
                      device)
    if args.gaf and mode == "binary":
        _write_gaf(args.graph, ref_chr, output_tsv, snarls_chr,
                   os.path.join(args.output, "binary_table_vcf.gaf"))
    elif args.gaf:
        logger.warning(
            "-g/--gaf: GAF emission needs the pure binary mode (it "
            "consumes the GROUP_PATHS column, absent from the %s "
            "layout); skipping.", mode)
    t_end = time.time()
    logger.info("GWAS time analysis : %.3f s", t_end - t_gwas)
    logger.info("Total time : %.3f s", t_end - t_start)
    return 0


def _write_gaf(graph_path, ref_chr, output_tsv, snarls_chr,
               output_gaf) -> None:
    """The two GAF files of the binary table (stoat_tpu/cli.py:337-346):
    the graph loaded by content (GFA, .hg, .pg or .gbz), its node
    lengths, then :func:`~stoat_tpu_torch.gaf.gaf_creation`."""
    from stoat_tpu_torch.gaf import gaf_creation
    from stoat_tpu_torch.graph.formats import load_graph
    t0 = time.time()
    graph = load_graph(graph_path, ref_chr or None)
    node_lengths = {nid: graph.node_length(nid) for nid in graph.node_ids()}
    gaf_creation(output_tsv, snarls_chr, node_lengths, output_gaf)
    logger.info("GAF output : %.3f s", time.time() - t0)


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


def main_bh_correct(argv: List[str]) -> int:
    """stoat_tpu/cli.py:359-380: the TSV is rewritten in place."""
    ap = argparse.ArgumentParser(prog="python -m stoat_tpu_torch BHcorrect")
    ap.add_argument("-t", "--tsv", required=True)
    ap.add_argument("-p", "--p-col", type=int, required=True,
                    help="1-indexed p-value column")
    ap.add_argument("-a", "--adjusted-col", type=int, required=True,
                    help="1-indexed adjusted-p column")
    ap.add_argument("-v", "--top-variant", default="top_variant.tsv")
    ap.add_argument("-o", "--output", default="output")
    ap.add_argument("-V", "--verbose", type=int, default=1)
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    _check_file(args.tsv)
    os.makedirs(args.output, exist_ok=True)

    from stoat_tpu_torch.post import add_bh_adjusted_column
    add_bh_adjusted_column(
        args.tsv, args.output,
        os.path.join(args.output, args.top_variant),
        args.p_col - 1, args.adjusted_col - 1)
    return 0


def main_simulate(argv: List[str]) -> int:
    """stoat_tpu/cli.py:414-430."""
    ap = argparse.ArgumentParser(prog="python -m stoat_tpu_torch simulate")
    ap.add_argument("-o", "--output", default="simulated")
    ap.add_argument("-n", "--samples", type=int, default=200)
    ap.add_argument("-s", "--snarls", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--effect-fraction", type=float, default=0.2)
    ap.add_argument("--effect-shift", type=float, default=0.35)
    args = ap.parse_args(argv)
    from stoat_tpu_torch.simulate import generate_dataset
    files = generate_dataset(args.output, args.samples, args.snarls,
                             args.seed, effect_fraction=args.effect_fraction,
                             effect_shift=args.effect_shift)
    for key, path in files.items():
        print(f"{key}\t{path}")
    return 0


def main_truth(argv: List[str]) -> int:
    """stoat_tpu/cli.py:433-447: one JSON line."""
    ap = argparse.ArgumentParser(prog="python -m stoat_tpu_torch truth")
    ap.add_argument("-r", "--results", required=True,
                    help="results TSV from stoat vcf")
    ap.add_argument("-f", "--freq", required=True,
                    help="truth allele-frequency TSV")
    ap.add_argument("-p", "--p-threshold", type=float, default=0.05)
    ap.add_argument("-t", "--freq-threshold", type=float, default=0.2)
    args = ap.parse_args(argv)
    _check_file(args.results)
    _check_file(args.freq)
    import json
    from stoat_tpu_torch.simulate import verify_truth
    print(json.dumps(verify_truth(args.results, args.freq,
                                  args.p_threshold, args.freq_threshold)))
    return 0


def main_plot(argv: List[str]) -> int:
    """QQ/Manhattan plots from a results TSV and per-snarl boxplots from
    -T table dumps (stoat_tpu/cli.py:463-520)."""
    ap = argparse.ArgumentParser(prog="python -m stoat_tpu_torch plot")
    ap.add_argument("kind", choices=["qq", "manhattan", "boxplot",
                                     "histogram", "scatter", "report"])
    ap.add_argument("-t", "--tsv", metavar="FILE",
                    help="results TSV (qq/manhattan)")
    ap.add_argument("-c", "--column", metavar="NAME",
                    help="p-value column (default: the mode's P column)")
    ap.add_argument("-d", "--tables", metavar="DIR",
                    help="-T per-snarl table directory (boxplot)")
    ap.add_argument("-p", "--phenotype", metavar="FILE",
                    help="FID/IID/PHENO phenotype file (boxplot)")
    ap.add_argument("-o", "--output", required=True,
                    help="output PNG (qq/manhattan/histogram/scatter) "
                         "or directory (boxplot/report)")
    ap.add_argument("--x-col", type=int, default=0,
                    help="x column index (scatter) / value column "
                         "(histogram)")
    ap.add_argument("--y-col", type=int, default=1,
                    help="y column index (scatter)")
    ap.add_argument("--color-col", type=int, default=-1,
                    help="coloring column index (scatter)")
    ap.add_argument("--bins", type=int, default=50,
                    help="bin count (histogram)")
    ap.add_argument("--log-y", action="store_true")
    args = ap.parse_args(argv)

    from stoat_tpu_torch import plots
    if args.kind == "boxplot":
        if not args.tables or not args.phenotype:
            ap.error("boxplot requires -d/--tables and -p/--phenotype")
        written = plots.snarl_boxplots(args.phenotype, args.tables,
                                       args.output)
        logger.info("Wrote %d boxplots to %s", len(written), args.output)
        return 0
    if not args.tsv:
        ap.error(f"{args.kind} requires -t/--tsv")
    _check_file(args.tsv)
    if args.kind == "qq":
        plots.qq_plot(args.tsv, args.output, args.column)
    elif args.kind == "manhattan":
        plots.manhattan_plot(args.tsv, args.output, args.column)
    elif args.kind == "histogram":
        plots.histogram_plot(args.tsv, args.output, column=args.x_col,
                             bins=args.bins, log_y=args.log_y)
    elif args.kind == "scatter":
        plots.scatter_plot(args.tsv, args.output, x_col=args.x_col,
                           y_col=args.y_col, color_col=args.color_col,
                           log_y=args.log_y)
    else:
        written = plots.report_plots(args.tsv, args.output, args.column)
        logger.info("Wrote %d report plots to %s", len(written),
                    args.output)
        return 0
    logger.info("Wrote %s", args.output)
    return 0


def print_help() -> None:
    sys.stderr.write(
        "usage: python -m stoat_tpu_torch <command> [options]\n\n"
        "commands:\n"
        "  vcf        VCF-based GWAS: binary (-b), quantitative (-q),\n"
        "             both, mixed model (-q -k --lmm) or eQTL (-e -G),\n"
        "             each with optional covariates -c/-C, -T regression\n"
        "             tables, --permutations and, with -b, GAF files of\n"
        "             the graph -p (-g); or the snarl decomposition alone\n"
        "             (-p -d)\n"
        "  graph      graph-path-based association (binary phenotype)\n"
        "  BHcorrect  Benjamini-Hochberg correction of a results TSV\n"
        "  simulate   generate a simulated dataset with truth labels\n"
        "  truth      precision/recall of results vs simulated truth\n"
        "  plot       QQ/Manhattan/boxplot/histogram/scatter/report plots\n"
        "             (needs matplotlib)\n"
        "  version    print version\n")


COMMANDS = {"vcf": main_vcf, "graph": main_graph,
            "BHcorrect": main_bh_correct, "simulate": main_simulate,
            "truth": main_truth, "plot": main_plot}


@trace.spanned("job", root=True)
def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print_help()
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd in COMMANDS:
        return COMMANDS[cmd](rest)
    if cmd == "version":
        print(f"stoat-tpu-torch {__version__}")
        return 0
    if cmd in ("-h", "--help", "help"):
        print_help()
        return 0
    sys.stderr.write(f"unknown command: {cmd}\n")
    print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
