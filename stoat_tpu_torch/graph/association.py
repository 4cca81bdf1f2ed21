"""Graph-mode association (``stoat graph``) on one device.

The port of stoat_tpu/graph/association.py.  The host layers are the
port's copies: the native graph core (native/graph_core.cpp: GFA load or
the in-memory feed of .hg/.pg/.gbz, snarl finding, walk-set partitioning,
the tree walk and the row formatter), the Python partitioner and snarl
helpers (graph/partition.py), the parsers and the writer.  What runs on
the device is K6, ``_graph_stats_fused`` (:496-513):
chi-squared 2x2, Fisher and chi-squared 2xN on every tested snarl's
partition counts, one row per snarl, then the rows' splice and write.

CUDA tensors run csrc/graph_stats.cu and then the chi-squared tails on
csrc/chi2_tail.cu (K5, as on the ``vcf -b`` path); CPU tensors run the
plain version.  All three statistics are computed for every row, as in JAX;
the writer picks the 2x2 pair when a snarl has two partitions and the 2xN
p otherwise.

:data:`GRAPH_PATHS` counts the runs of each host path: ``native`` (the
one-call native prepare) and ``python`` (``test_snarls``, the Python twin
taken under TRACE logging, with STOAT_GRAPH_PYTHON=1, or when the native
core cannot be built).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from stoat_tpu_torch import writer as W
from stoat_tpu_torch.convert import to_graph_counts
from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.graph.gfa import GfaGraph
from stoat_tpu_torch.graph.partition import (_NativePartitions,
                                             PathPartitioner,
                                             _is_regular_snarl,
                                             _snarl_min_max_len,
                                             _write_fasta_partitions)
from stoat_tpu_torch.graph.snarls import Snarl, SnarlForest, find_snarls
from stoat_tpu_torch.io.phenotype import parse_binary_pheno
from stoat_tpu_torch.kernels import I64, VOIDP, check_tensor, launch
from stoat_tpu_torch.logsetup import TRACE
from stoat_tpu_torch.pipeline.fetch import fetch_async
from stoat_tpu_torch.stats.chi2 import (chi2_2x2_stat, chi2_2xn_stat,
                                        finish_chi2_pvalues)
from stoat_tpu_torch.stats.fisher import fisher_exact_2x2_plain

logger = logging.getLogger("stoat")

__all__ = ["GRAPH_PATHS", "graph_stats", "graph_stats_plain",
           "run_graph_association", "test_snarls"]

GRAPH_PATHS: Dict[str, int] = {"native": 0, "python": 0}

Pvalues = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def graph_stats_plain(G0: torch.Tensor, G1: torch.Tensor,
                      mask: torch.Tensor) -> Pvalues:
    """Plain PyTorch version of :func:`graph_stats`."""
    a, b, c, d = G0[:, 0], G0[:, 1], G1[:, 0], G1[:, 1]
    stat, invalid, zero_expected = chi2_2x2_stat(a, b, c, d)
    p22 = finish_chi2_pvalues(stat, torch.ones_like(stat), invalid,
                              zero_expected)
    pf = fisher_exact_2x2_plain(a, b, c, d)
    statn, dfn, invalidn = chi2_2xn_stat(G0, G1, mask)
    pn = finish_chi2_pvalues(statn, dfn, invalidn,
                             torch.zeros_like(invalidn))
    return p22, pf, pn


def _graph_stats_cuda(G0, G1, mask) -> Pvalues:
    device = G0.device
    B, Pm = G0.shape
    check_tensor(G0, "G0", torch.int32, (B, Pm), device)
    check_tensor(G1, "G1", torch.int32, (B, Pm), device)
    check_tensor(mask, "mask", torch.bool, (B, Pm), device)

    def empty(dtype):
        return torch.empty(B, dtype=dtype, device=device)
    stat, invalid, zexp = (empty(torch.float64), empty(torch.bool),
                           empty(torch.bool))
    pf = empty(torch.float64)
    statn, dfn, invalidn = (empty(torch.float64), empty(torch.float64),
                            empty(torch.bool))
    launch("graph_stats", [VOIDP] * 10 + [I64] * 2,
           [G0.data_ptr(), G1.data_ptr(), mask.data_ptr(),
            *(t.data_ptr() for t in (stat, invalid, zexp, pf, statn, dfn,
                                     invalidn)), B, Pm], device)
    p22 = finish_chi2_pvalues(stat, torch.ones_like(stat), invalid, zexp)
    pn = finish_chi2_pvalues(statn, dfn, invalidn,
                             torch.zeros_like(invalidn))
    return p22, pf, pn


def graph_stats(G0: torch.Tensor, G1: torch.Tensor,
                mask: torch.Tensor) -> Pvalues:
    """(p_chi2_2x2, p_fisher, p_chi2_2xn), float64 [B] each, NaN = "NA",
    of int32 [B, Pmax] control (G0) and case (G1) partition counts with a
    bool column mask; the 2x2 tests take the first two columns.

    CUDA tensors run csrc/graph_stats.cu, one thread per row, then the
    two chi-squared tails on csrc/chi2_tail.cu; both are launch-bound at
    any real B.  CPU tensors run the plain version."""
    if kernels_enabled(G0.device):
        return _graph_stats_cuda(G0, G1, mask)
    return graph_stats_plain(G0, G1, mask)


def _device_pvalues(kinds, part_offs, g0, g1, device):
    """K6 on ``device`` over a prepare's partition counts: host (p22, pf,
    pn, k) of the tested rows, after one host copy."""
    G0, G1, mask, k = to_graph_counts(kinds, part_offs, g0, g1, device)
    if not len(k):
        empty = np.zeros(0)
        return empty, empty, empty, k
    res = fetch_async(dict(zip(("p22", "pf", "pn"),
                               graph_stats(G0, G1, mask))))
    return res["p22"], res["pf"], res["pn"], k


def test_snarls(g: GfaGraph, forest: SnarlForest,
                partitioner: PathPartitioner,
                case_set: Set[str], control_set: Set[str],
                test_method: str, output_format: str,
                allele_size_limit: int, reference_sample: str,
                out_fh, device: torch.device) -> int:
    """Walk the snarl tree and run the association tests on ``device``.
    Returns the number of snarls written.  A copy of stoat_tpu's
    test_snarls (:263-430); only its statistics go through
    :func:`graph_stats`."""
    from stoat_tpu_torch.graph.decompose import _reference_offsets

    if output_format == "tsv":
        W.write_binary_header(out_fh)

    ref_names = {reference_sample} if reference_sample else set()
    ref_offsets = _reference_offsets(g, ref_names)

    def coordinates(snarl: Snarl) -> Tuple[str, int, int]:
        for chrom, offs in ref_offsets.items():
            if snarl.start_node in offs and snarl.end_node in offs:
                a = offs[snarl.start_node]
                b = offs[snarl.end_node]
                if a > b:
                    a, b = b, a
                    first, last = snarl.end_node, snarl.start_node
                else:
                    first, last = snarl.start_node, snarl.end_node
                return chrom, a + g.node_length(first), b
        return "NA", 0, 0

    # candidate snarls in tree order (a stack of top-level snarls and a
    # conditional descent, graph_path_association_finder.cpp:37-50)
    n_written = 0
    stack = sorted(forest.top_level(), reverse=True)
    rows = []
    # one parallel native pass computes every regular snarl's walk-set
    # partition counts up front; TRACE keeps the Python partitioner (it
    # dumps the full sets)
    native_parts = None
    if not logger.isEnabledFor(TRACE) and forest.snarls:
        try:
            native_parts = _NativePartitions(forest, partitioner,
                                             case_set, control_set)
        except (RuntimeError, OSError, ImportError) as e:
            logger.debug("native partitioner unavailable (%s)", e)
    while stack:
        i = stack.pop()
        snarl = forest.snarls[i]
        mn, mx = _snarl_min_max_len(g, forest, i)
        if mx < allele_size_limit:
            continue
        path_lengths = f"{mn},{mx}"
        regular = _is_regular_snarl(g, forest, i)
        if native_parts is not None and regular:
            # (n_in_case, n_in_control, representative sample)
            parts = native_parts.counts(i)
        else:
            partitions = partitioner.partition_samples_in_snarl(
                forest, i, regular)
            if logger.isEnabledFor(TRACE):
                logger.trace("Test snarl %s", snarl.id_str)
                for part in partitions:
                    logger.trace("\tPARTITION")
                    for sample in sorted(part):
                        logger.trace("\t\t%s", sample)
            parts = [(sum(1 for s in p if s in case_set),
                      sum(1 for s in p if s in control_set),
                      sorted(p)[0]) for p in partitions]
        descend = True
        if len(parts) > 1:
            if test_method == "exact":
                samples_to_write: Dict[str, bool] = {}
                matched = False
                for nc, nt, rep in parts:
                    # partition == case/control set <=> it holds every
                    # member of that set and nothing else
                    hit = ((nt == 0 and nc == len(case_set)) or
                           (nc == 0 and nt == len(control_set)))
                    if hit:
                        matched = True
                        descend = False
                        if output_format == "fasta":
                            samples_to_write[rep] = True
                    elif output_format == "fasta":
                        samples_to_write[rep] = False
                if matched:
                    if output_format == "tsv":
                        chrom, a, b = coordinates(snarl)
                        rows.append((chrom, a, b, snarl.id_str,
                                     path_lengths, None, None, "NA",
                                     snarl.depth))
                    else:
                        _write_fasta_partitions(
                            g, forest, i, samples_to_write, out_fh,
                            partitioner, reference_sample)
                    n_written += 1
            else:
                g0 = [nc for nc, _nt, _r in parts]
                g1 = [nt for _nc, nt, _r in parts]
                chrom, a, b = coordinates(snarl)
                group_paths = W.format_group_paths(g0, g1)
                rows.append((chrom, a, b, snarl.id_str, path_lengths,
                             (tuple(g0), tuple(g1)), None, group_paths,
                             snarl.depth))
                n_written += 1
                if output_format == "fasta":
                    samples_to_write = {rep: True
                                        for _nc, _nt, rep in parts}
                    _write_fasta_partitions(g, forest, i, samples_to_write,
                                            out_fh, partitioner,
                                            reference_sample)
        if descend:
            for c in sorted(snarl.children, reverse=True):
                stack.append(c)

    if output_format != "tsv":
        return n_written
    # the tested rows' counts, flattened as the native prepare lays them
    # out, through K6 on the device in one batch
    tested = [r[5] for r in rows if r[5] is not None]
    k = np.array([len(t[0]) for t in tested], np.int64)
    offs = np.concatenate([[0], np.cumsum(k)]).astype(np.int64)
    flat0 = np.array([v for t in tested for v in t[0]], np.int64)
    flat1 = np.array([v for t in tested for v in t[1]], np.int64)
    p22, pf, pn, k_arr = _device_pvalues(np.ones(len(tested), np.uint8),
                                         offs, flat0, flat1, device)
    ti = 0
    for r in rows:
        chrom, a, b, sid, pl, counts, _pf, gp, depth = r
        if counts is None:
            out_fh.write(f"{chrom}\t{a}\t{b}\t{sid}\t{pl}\tNA\tNA\t"
                         f"{gp}\t{depth}\n")
            continue
        if k_arr[ti] == 2:
            chi_s, fis_s = W.format_p(p22[ti]), W.format_p(pf[ti])
        else:
            chi_s, fis_s = W.format_p(pn[ti]), "NA"
        out_fh.write(f"{chrom}\t{a}\t{b}\t{sid}\t{pl}\t{fis_s}\t"
                     f"{chi_s}\t{gp}\t{depth}\n")
        ti += 1
    return n_written


def _batch_test_and_write(blob, kinds, part_offs, g0, g1, out_fh,
                          device) -> None:
    """K6 over the native prepare's partition counts, then the rows'
    splice and write (stoat_tpu's :516-575, byte-identical)."""
    from stoat_tpu_torch.native import graph_format_rows_native

    n_rows = len(kinds)
    p22, pf, pn, k_arr = _device_pvalues(kinds, part_offs, g0, g1, device)
    text = graph_format_rows_native(blob, kinds, p22, pf, pn,
                                    (k_arr == 2).astype(np.uint8))
    if text is not None:
        out_fh.write(text.decode())
        return
    rows = blob.split(b"\0")[:n_rows]
    ti = 0
    for i, row in enumerate(rows):
        if kinds[i] == 0:
            out_fh.write(row.decode() + "\n")
            continue
        prefix, suffix = row.split(b"\x01", 1)
        if k_arr[ti] == 2:
            chi_s, fis_s = W.format_p(p22[ti]), W.format_p(pf[ti])
        else:
            chi_s, fis_s = W.format_p(pn[ti]), "NA"
        out_fh.write(f"{prefix.decode()}\t{fis_s}\t{chi_s}\t"
                     f"{suffix.decode()}\n")
        ti += 1


def _run_graph_association_native(graph_path: str, fmt: str,
                                  binary_path: str, test_method: str,
                                  output_format: str,
                                  allele_size_limit: int,
                                  reference_sample: str, output_dir: str,
                                  device: torch.device) -> Optional[int]:
    """The `stoat graph` fast path (stoat_tpu's :578-626): one native call
    does the snarl finding, partitioning and tree walk; TSV rows get K6 on
    ``device``; FASTA text comes back complete from the native walk.
    Returns None when the native core is unavailable."""
    from stoat_tpu_torch.native import (graph_assoc_mem_native,
                                        graph_assoc_native)

    samples: List[str] = []
    pheno, samples = parse_binary_pheno(binary_path, samples)
    refs = {reference_sample} if reference_sample else None
    if fmt == "gfa":
        got = graph_assoc_native(graph_path, refs, samples,
                                 pheno.astype(np.uint8), test_method,
                                 allele_size_limit,
                                 output_format=output_format)
    elif fmt in ("hg", "pg", "gbz"):
        from stoat_tpu_torch.graph.formats import load_graph
        g = load_graph(graph_path, refs)
        got = graph_assoc_mem_native(g, refs, samples,
                                     pheno.astype(np.uint8), test_method,
                                     allele_size_limit,
                                     output_format=output_format)
    else:
        return None
    if got is None:
        return None
    blob, kinds, part_offs, g0, g1, n_snarls = got
    GRAPH_PATHS["native"] += 1
    if output_format == "fasta":
        out_path = os.path.join(output_dir, "binary_output.fasta")
        with open(out_path, "wb") as fh:
            fh.write(blob)
        logger.info("Wrote FASTA for %d snarls to %s", n_snarls, out_path)
        return 0
    out_path = os.path.join(output_dir, "binary_table_graph.tsv")
    with open(out_path, "w") as fh:
        W.write_binary_header(fh)
        _batch_test_and_write(blob, kinds, part_offs, g0, g1, fh, device)
    logger.info("Wrote %d snarls to %s", len(kinds), out_path)
    return 0


def run_graph_association(graph_path: str, dist_path: str, binary_path: str,
                          test_method: str, output_format: str,
                          allele_size_limit: int, reference_sample: str,
                          output_dir: str, device: torch.device) -> int:
    """``stoat graph`` on ``device`` (stoat_tpu's :629-689, graph.cpp:
    52-290): writes ``binary_table_graph.tsv`` or ``binary_output.fasta``
    in ``output_dir``; returns the exit code."""
    from stoat_tpu_torch.graph.formats import (load_graph,
                                               sniff_graph_format)
    if dist_path:
        logger.warning(
            "-d/--dist: the SnarlDistanceIndex file %s is accepted for "
            "stoat interface parity but NOT read — the snarl tree is "
            "recomputed from the graph itself (snarl ids may differ in "
            "orientation from the reference's .dist-derived ids; see "
            "DESIGN.md §7).", dist_path)
    if (not logger.isEnabledFor(TRACE)
            and os.environ.get("STOAT_GRAPH_PYTHON") != "1"):
        try:
            res = _run_graph_association_native(
                graph_path, sniff_graph_format(graph_path), binary_path,
                test_method, output_format, allele_size_limit,
                reference_sample, output_dir, device)
        except RuntimeError as e:
            if "No graph paths" in str(e):   # graph.cpp-style soft error
                logger.error("%s", e)
                return 1
            raise SystemExit(str(e))
        if res is not None:
            return res
        logger.debug("native graph core unavailable; Python path")
    refs = {reference_sample} if reference_sample else None
    try:
        g = load_graph(graph_path, refs)
    except RuntimeError as e:
        raise SystemExit(str(e))
    forest = find_snarls(g)

    samples: List[str] = []
    pheno, samples = parse_binary_pheno(binary_path, samples)
    case_set = {s for s, v in zip(samples, pheno) if v}
    control_set = {s for s, v in zip(samples, pheno) if not v}

    wanted = case_set | control_set
    sample_paths = [p for p in g.paths if p.sample in wanted]
    if not sample_paths:
        logger.error("No graph paths match the phenotype samples")
        return 1
    partitioner = PathPartitioner(g, sample_paths)
    GRAPH_PATHS["python"] += 1

    # contract file names (graph_simu_test.cpp:38,72)
    out_name = ("binary_table_graph.tsv" if output_format == "tsv"
                else "binary_output.fasta")
    out_path = os.path.join(output_dir, out_name)
    with open(out_path, "w") as fh:
        n = test_snarls(g, forest, partitioner, case_set, control_set,
                        test_method, output_format, allele_size_limit,
                        reference_sample, fh, device)
    logger.info("Wrote %d snarls to %s", n, out_path)
    return 0
