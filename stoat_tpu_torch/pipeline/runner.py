"""VCF-mode orchestration on one device: stream -> pack -> device batch ->
TSV, for every single-device ``vcf`` mode: a binary trait (``-b``, or ``-b
-c``: logistic regression), a quantitative one (``-q``, with optional
covariates), both in one pass (``-b -q``), the mixed model (``-q -k
--lmm``) and eQTL (``-e -G``).

The port of the single-device paths of stoat_tpu/pipeline/runner.py
run_vcf_analysis (:412-814).  The VCF is read one chromosome at a time by
the native C++ core on a prefetch thread; each chromosome's packed words
are uploaded once, after the parse, from pinned memory; its snarls go
through the mode's pipeline in chunks; and a writer thread waits for each
chunk's host copies, formats the rows and writes them in snarl-file
order.  eQTL runs inline instead, as in stoat_tpu (:551, :1067-1107): its
gene pairing needs each chunk's filter flags on the host.  A
``secondary`` phenotype (:440-481) runs a second analysis on the same
chunks into a second table; binary with a quantitative secondary shares
one K1 pass (pipeline/quantitative.py dual_analyze_chromosome), unless -T
asks for tables (:690-694).  With -T (``table_threshold``), the regression
modes also write, for each snarl whose printed P passes the threshold, its
sample x path table into ``regression_dir`` (:1019-1064); binary and eQTL
runs write none.  ``--resume`` checkpoints every completed chromosome in a
``<output>.progress`` sidecar per output.

The helpers below are copies of stoat_tpu/pipeline/runner.py:42-190,
:284-409 and :931-953: that module imports the JAX pipeline at import
time.  The JAX runner's streamed, deduplicated word uploads (:191-281)
existed for a slow network link and are not ported: uploading after the
parse has no stale rows to patch.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from stoat_tpu_torch import writer as W
from stoat_tpu_torch.convert import (chunk_words, pheno_masks,
                                     to_binary_pheno, to_covariates,
                                     to_eqtl_expr, to_eqtl_pairs,
                                     to_lmm_inputs, to_quant_inputs,
                                     upload_words)
from stoat_tpu_torch.formatting import is_pvalue_significant, pair_to_string
from stoat_tpu_torch.io.phenotype import QtlData
from stoat_tpu_torch.io.snarl_file import SnarlData
from stoat_tpu_torch.io.vcf import VcfReader
from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix
from stoat_tpu_torch.pipeline.binary import binary_analyze_chromosome
from stoat_tpu_torch.pipeline.fetch import fetch_async
from stoat_tpu_torch.pipeline.quantitative import (
    PrefixView, binary_covar_analyze_chromosome, dual_analyze_chromosome,
    eqtl_design_for_chromosome, eqtl_regress_pairs, lmm_analyze_chromosome,
    quantitative_analyze_chromosome)
from stoat_tpu_torch.tables import (pack_chromosome_chunks,
                                    tokenize_chromosome)

logger = logging.getLogger("stoat")

__all__ = ["run_vcf_analysis", "iter_chromosome_matrices", "INGEST_COUNTS",
           "MODES", "found_gene_snarl"]

MODES = ("binary", "binary_covar", "quantitative", "lmm", "eqtl")
# a secondary phenotype's modes and the key of its phenotype input
SECONDARY_PHENOTYPE = {"binary": "binary_phenotype",
                       "binary_covar": "binary_phenotype",
                       "quantitative": "quantitative_phenotype",
                       "lmm": "lmm_ctx"}

# chromosomes read by each VCF reader since the process started (the
# native core, or the pure-Python fallback)
INGEST_COUNTS: Dict[str, int] = {"native": 0, "python": 0}


def iter_chromosome_matrices(vcf_path: str, n_haplotypes: int,
                             snarls_chr: Dict[str, List[SnarlData]]):
    """Yield (chrom, edge-matrix object) per chromosome.

    Prefers the native C++ core (words already bit-packed) and falls back
    to the pure-Python reader when the toolchain is unavailable."""
    yielded_any = False
    try:
        from stoat_tpu_torch.matrix import PackedEdgeMatrix
        from stoat_tpu_torch.native import NativeVcfMatrixReader
        reader = NativeVcfMatrixReader(vcf_path)
        try:
            for chrom, words, n_haps, edges in reader.chunks_packed():
                yielded_any = True
                matrix = PackedEdgeMatrix(words, n_haps, edges)
                matrix.n_records, matrix.n_with_at = \
                    getattr(reader, "last_counts", (-1, -1))
                matrix.resolve_idx_native = \
                    getattr(reader, "last_resolver", None)
                INGEST_COUNTS["native"] += 1
                yield chrom, matrix
        finally:
            # also runs on GeneratorExit when a consumer abandons the
            # generator early: the producer thread must not leak
            reader.close()
        return
    except (RuntimeError, OSError) as e:
        if yielded_any:
            # chromosomes already went downstream: falling back to the
            # Python reader would yield them again from the top of the
            # VCF and duplicate output rows
            raise
        logger.warning("native VCF core unavailable (%s); using the "
                       "Python reader", e)

    reader = VcfReader(vcf_path)
    try:
        for chrom, records in reader.chromosome_chunks():
            matrix = EdgeHaplotypeMatrix(
                n_haplotypes,
                initial_rows=max(4 * len(snarls_chr.get(chrom, [])), 64))
            n_records = n_with_at = 0
            for rec in records:
                n_records += 1
                n_with_at += 1 if rec.at_paths else 0
                matrix.add_record(rec)
            matrix.n_records, matrix.n_with_at = n_records, n_with_at
            INGEST_COUNTS["python"] += 1
            yield chrom, matrix
    finally:
        reader.close()


def _progress_path(data_path: str) -> str:
    return data_path + ".progress"


def _read_progress(data_path: str) -> Dict[str, int]:
    """{chrom: byte offset after its last row} in completion order."""
    out: Dict[str, int] = {}
    try:
        with open(_progress_path(data_path)) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2:
                    try:
                        out[parts[0]] = int(parts[1])
                    except ValueError:
                        pass
    except OSError:
        pass
    return out


def _record_progress(fh, data_path: str, chrom: str):
    """Durable per-chromosome checkpoint, run on the writer thread after
    every row write of the chromosome: fsync the data file, then append
    ``chrom<TAB>offset`` to the sidecar."""
    fh.flush()
    buf = getattr(fh, "buffer", None)
    if buf is not None:
        off = buf.tell()
    else:
        off = fh.tell()
    os.fsync(fh.fileno())
    with open(_progress_path(data_path), "a") as pf:
        pf.write(f"{chrom}\t{off}\n")
        pf.flush()
        os.fsync(pf.fileno())
    return 0


def _prefetched(gen):
    """Run a generator on a background thread, one item ahead, so the
    next chromosome's native ingest (which releases the GIL) overlaps
    this one's packing, device work and writing."""
    q: "queue.Queue" = queue.Queue(maxsize=1)
    sentinel = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


class _QuadTokenizer:
    """Tokenizes every chromosome's snarl paths on a background thread,
    concurrently with the first chromosome's VCF ingest; ``get`` blocks
    until that chromosome's tokens are ready."""

    def __init__(self, snarls_chr: Dict[str, List[SnarlData]]):
        self._results: Dict[str, object] = {}
        self._events = {c: threading.Event() for c in snarls_chr}
        self._snarls_chr = snarls_chr
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        for chrom, snarls in self._snarls_chr.items():
            try:
                self._results[chrom] = tokenize_chromosome(snarls)
            except Exception:                      # fall back in-line
                self._results[chrom] = None
            self._events[chrom].set()

    def get(self, chrom: str):
        event = self._events.get(chrom)
        if event is None:
            return None
        event.wait()
        return self._results.get(chrom)


class _PipelinedWriter:
    """Serial FIFO executor for the fetch+format+write work, so that chunk
    N's host copy, row formatting and TSV write overlap the dispatch of
    chunk N+1; output order stays deterministic.  Filtered counts are kept
    per output (``tag``)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self.filtered: Dict[str, int] = {}
        self._errors: List[BaseException] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._errors:
                continue            # drain after failure (no deadlock)
            fn, tag = item
            try:
                got = fn()
                if got:
                    self.filtered[tag] = self.filtered.get(tag, 0) + got
            except BaseException as e:
                self._errors.append(e)

    def count(self, tag: str = "primary") -> int:
        return self.filtered.get(tag, 0)

    def submit(self, fn, tag: str = "primary") -> None:
        if self._errors:
            raise self._errors[0]
        self._q.put((fn, tag))

    def close(self) -> Dict[str, int]:
        self._q.put(None)
        self._thread.join()
        if self._errors:
            raise self._errors[0]
        return self.filtered


def found_gene_snarl(gene_position: List[QtlData], start_pos: int,
                     end_pos: int, window: int) -> List[int]:
    """Genes overlapping [start-window, end+window]
    (snarl_analyzer.cpp:471-491)."""
    lo = start_pos - window if start_pos > window else 0
    hi = end_pos + window
    return [i for i, g in enumerate(gene_position)
            if not (g.end_pos < lo or g.start_pos > hi)]


def _validate_secondary(secondary: Dict) -> None:
    """Fail fast on a malformed ``secondary`` dict (the contract in
    run_vcf_analysis's docstring)."""
    if "mode" not in secondary or "output_tsv" not in secondary:
        raise ValueError(
            "secondary dict must carry 'mode' and 'output_tsv' keys; "
            f"got keys {sorted(secondary)}")
    sec_mode = secondary["mode"]
    pheno_key = SECONDARY_PHENOTYPE.get(sec_mode)
    if pheno_key is None:
        raise ValueError(
            f"secondary mode {sec_mode!r} is not one of binary/"
            "binary_covar/quantitative/lmm")
    if secondary.get(pheno_key) is None:
        raise ValueError(
            f"secondary mode {sec_mode!r} requires a non-None "
            f"{pheno_key!r} entry in the secondary dict")


@dataclass
class _Run:
    """One run's settings and its per-run device inputs (``consts``,
    uploaded on the first chunk that needs them)."""

    mode: str
    phenotype: object
    covariate: Optional[np.ndarray]
    device: torch.device
    thresholds: tuple
    chunk_size: int
    window: int
    table_threshold: float = -1
    regression_dir: str = ""
    samples: List[str] = field(default_factory=list)
    secondary: Optional[Dict] = None
    sec_fh: object = None
    consts: Dict[str, object] = field(default_factory=dict)

    @property
    def dual(self) -> bool:
        """Binary with a quantitative secondary: one K1 pass for both
        (not with -T, as in stoat_tpu, :690-694)."""
        return (self.secondary is not None and self.mode == "binary"
                and self.secondary["mode"] == "quantitative"
                and self.table_threshold == -1)


def _inputs(run: _Run, key: str, mode: str, phenotype, packed, words):
    """The device inputs of ``mode`` (binary: the packed masks;
    binary_covar: the case indicator; quantitative: phenotype and
    covariates; lmm: rotation, rotated phenotype and covariates; eqtl: the
    covariates), uploaded once per run under ``key``."""
    got = run.consts.get(key)
    if got is None:
        n = packed.n_haplotypes // 2
        if mode == "eqtl":
            got = to_covariates(run.covariate, n, run.device)
        elif mode == "binary":
            got = pheno_masks(phenotype, packed.n_haplotypes,
                              int(words.shape[1]), run.device)
        elif mode == "binary_covar":
            got = to_binary_pheno(phenotype, run.device)
        elif mode == "quantitative":
            got = to_quant_inputs(phenotype, run.covariate, n, run.device)
        else:
            got = to_lmm_inputs(phenotype, run.covariate, n, run.device)
        run.consts[key] = got
    return got


def _analyze(run: _Run, key: str, mode: str, phenotype, packed, words):
    """Queue one chunk of ``mode`` on the device; returns its
    ``fetch.HostResult`` and the writer function of its table."""
    c = _inputs(run, key, mode, phenotype, packed, words)
    th, device = run.thresholds, run.device
    if mode == "binary":
        return (binary_analyze_chromosome(packed, phenotype, *th, device,
                                          words=words, pheno=c),
                W.write_binary_rows_batch)
    has_r2 = mode != "binary_covar"
    tables = run.table_threshold != -1
    if tables:
        write = partial(_write_quant_family, threshold=run.table_threshold,
                        regression_dir=run.regression_dir,
                        samples=run.samples, has_r2=has_r2)
    else:
        write = partial(W.write_quant_rows_batch, has_r2=has_r2)
    if mode == "binary_covar":
        res = binary_covar_analyze_chromosome(packed, c, *th, device,
                                              words=words, tables=tables)
    elif mode == "quantitative":
        res = quantitative_analyze_chromosome(packed, *c, *th, device,
                                              words=words, tables=tables)
    else:
        res = lmm_analyze_chromosome(packed, *c, *th, device, words=words,
                                     tables=tables)
    return res, write


def _write_quant_family(outf, chrom, snarls, res, threshold: float,
                        regression_dir: str, samples: List[str],
                        has_r2: bool) -> int:
    """A regression chunk under -T (stoat_tpu's _write_quant_family and
    _maybe_write_table, :1019-1064): its rows through the batch writer,
    whose bytes are the per-row writer's, then for each unfiltered snarl
    whose printed P passes ``threshold`` its table (writer.cpp:181-208)
    in ``regression_dir``: the used samples' normalised dosages over the
    kept paths.  Only those snarls' rows of the table view leave the
    device.  Returns the filtered count."""
    filtered = W.write_quant_rows_batch(outf, chrom, snarls, res,
                                        has_r2=has_r2)
    filtered_arr, p_arr = res["filtered"], res["p"]
    significant = [s for s in range(len(snarls)) if not filtered_arr[s]
                   and is_pvalue_significant(threshold, W.format_p(p_arr[s]))]
    if significant:
        norm, used, kept = res.tables.rows(significant)
        for i, s in enumerate(significant):
            snarl = snarls[s]
            W.write_significant_table(
                os.path.join(regression_dir,
                             pair_to_string(snarl.snarl_ids) + ".tsv"),
                norm[i][used[i]][:, kept[i]], snarl.path_strings,
                [name for name, u in zip(samples, used[i]) if u])
    return filtered


def _log_degenerate(chrom: str, matrix, n_snarls: int) -> None:
    """A header-only output with no explanation is a support ticket."""
    n_rec = getattr(matrix, "n_records", -1)
    n_at = getattr(matrix, "n_with_at", -1)
    if n_rec == 0:
        logger.warning(
            "Chromosome %s: the VCF contains no records for this "
            "chromosome; all %d snarls will be filtered.", chrom, n_snarls)
    elif n_at == 0:
        logger.warning(
            "Chromosome %s: 0 of %d VCF records carry a usable AT INFO "
            "field (vg deconstruct emits it; plain VCFs do not) — no "
            "genotype matrix can be built and all %d snarls will be "
            "filtered.", chrom, n_rec, n_snarls)
    elif matrix.n_rows == 0:
        logger.warning(
            "Chromosome %s: %d/%d AT-carrying records produced no matrix "
            "rows (no called alleles?); all %d snarls will be filtered.",
            chrom, n_at, n_rec, n_snarls)


def _dispatch_chromosome(outf, output_tsv, chrom, matrix, snarls, writer,
                         tokenizer, run: _Run) -> int:
    """Queue one chromosome's chunks on the device and their writes on
    the writer thread, then its checkpoints (the secondary output's first,
    so that a crash between the two reruns the chromosome).  eQTL runs
    inline instead (:func:`_eqtl_chromosome`) and returns its filtered
    count; the other modes return 0 (the writer counts)."""
    t0 = time.time()
    logger.info("Analysing chr : %s", chrom)
    _log_degenerate(chrom, matrix, len(snarls))
    if run.mode == "eqtl":
        filtered = _eqtl_chromosome(outf, chrom, matrix, snarls, tokenizer,
                                    run)
        _log_chromosome(chrom, len(snarls), filtered, t0)
        _record_progress(outf, output_tsv, chrom)
        return filtered
    chr_state: Dict[str, int] = {}
    writer.submit(lambda: chr_state.__setitem__("start", writer.count()))
    sec = run.secondary
    words = None
    for packed in pack_chromosome_chunks(snarls, matrix, run.chunk_size,
                                         quad_cache=tokenizer.get(chrom)):
        if words is None:
            # one upload per chromosome: every chunk shares its words
            words = upload_words(chunk_words(packed), run.device)
        if run.dual:
            masks = _inputs(run, "primary", "binary", run.phenotype, packed,
                            words)
            qpheno, covar = _inputs(run, "secondary", "quantitative",
                                    sec["quantitative_phenotype"], packed,
                                    words)
            res = dual_analyze_chromosome(packed, masks, qpheno, covar,
                                          *run.thresholds, run.device,
                                          words=words)
            writer.submit(partial(W.write_binary_rows_batch, outf, chrom,
                                  packed.snarls, res))
            writer.submit(partial(W.write_quant_rows_batch, run.sec_fh, chrom,
                                  packed.snarls, PrefixView(res)),
                          tag="secondary")
            continue
        # the writer thread waits for the chunk's host copies, then
        # formats and writes its rows (returns the filtered count)
        res, write = _analyze(run, "primary", run.mode, run.phenotype, packed,
                              words)
        writer.submit(partial(write, outf, chrom, packed.snarls, res))
        if sec is not None:
            mode = sec["mode"]
            res, write = _analyze(run, "secondary", mode,
                                  sec[SECONDARY_PHENOTYPE[mode]], packed,
                                  words)
            writer.submit(partial(write, run.sec_fh, chrom, packed.snarls,
                                  res), tag="secondary")

    def _chr_done(n=len(snarls)):
        _log_chromosome(chrom, n, writer.count() - chr_state.get("start", 0),
                        t0)
        return 0
    writer.submit(_chr_done)
    # durable checkpoints, strictly after the chromosome's rows (FIFO)
    if sec is not None:
        writer.submit(partial(_record_progress, run.sec_fh,
                              sec["output_tsv"], chrom))
    writer.submit(partial(_record_progress, outf, output_tsv, chrom))
    return 0


def _log_chromosome(chrom: str, n: int, filtered: int, t0: float) -> None:
    if filtered == n and n:
        logger.warning(
            "Chromosome %s: all %d snarls were filtered "
            "(min-individuals/min-haplotypes/MAF thresholds, or the "
            "snarl paths reference edges absent from the VCF's AT "
            "traversals).", chrom, filtered)
    logger.info("Number of snarl filtered in chr %s : %d", chrom, filtered)
    logger.info("Total time for chr %s : %.3f s", chrom, time.time() - t0)


def _eqtl_chromosome(outf, chrom, matrix, snarls, tokenizer,
                     run: _Run) -> int:
    """One chromosome of the eQTL mode (stoat_tpu's _write_eqtl,
    :1067-1107), inline: per chunk the design on the device, its filter
    flags and allele counts on the host, the (snarl, gene) pairs of the
    unfiltered snarls in (snarl, gene) order (genes within the window,
    :func:`found_gene_snarl`), their OLS on the device
    (quantitative.eqtl_regress_pairs) and one row per pair.  Filtered
    snarls write no row; returns their number."""
    gene_list = run.phenotype.get(chrom, [])
    th, device = run.thresholds, run.device
    words = expr = None
    filtered = 0
    for packed in pack_chromosome_chunks(snarls, matrix, run.chunk_size,
                                         quad_cache=tokenizer.get(chrom)):
        if words is None:
            words = upload_words(chunk_words(packed), device)
        covar = _inputs(run, "primary", "eqtl", None, packed, words)
        design = eqtl_design_for_chromosome(packed, covar, *th, device,
                                            words=words)
        flags = fetch_async({"filtered": design["filtered"],
                             "allele_paths": design["allele_paths"]})
        filtered_arr = flags["filtered"]
        allele_arr = flags["allele_paths"]
        pair_snarl: List[int] = []
        pair_gene: List[int] = []
        for s, snarl in enumerate(packed.snarls):
            if filtered_arr[s]:
                filtered += 1
                continue
            for g in found_gene_snarl(gene_list, snarl.start_pos,
                                      snarl.end_pos, run.window):
                pair_snarl.append(s)
                pair_gene.append(g)
        if not pair_snarl:
            continue
        if expr is None:
            # the chromosome's expression, uploaded once
            expr = to_eqtl_expr(gene_list, device)
        res = eqtl_regress_pairs(
            design, *to_eqtl_pairs(pair_snarl, pair_gene,
                                   int(design["X"].shape[0]), device), expr)
        del design
        p, r2, beta, se = (res[k] for k in ("p", "r2", "beta", "se"))
        for b, (s, g) in enumerate(zip(pair_snarl, pair_gene)):
            snarl = packed.snarls[s]
            W.write_eqtl_row(
                outf, chrom, snarl, snarl.type_var_str,
                gene_list[g].gene_name, W.format_p(p[b]),
                W.format_p(r2[b]), W.format_p(beta[b]), W.format_p(se[b]),
                allele_arr[s][: snarl.n_paths])
    return filtered


def run_vcf_analysis(
    vcf_path: str,
    snarls_chr: Dict[str, List[SnarlData]],
    output_tsv: str,
    phenotype,
    device: torch.device,
    mode: str = "binary",
    covariate: Optional[np.ndarray] = None,
    maf_threshold: float = 0.05,
    table_threshold: float = -1,
    min_individuals: int = 3,
    min_haplotypes: int = 5,
    windows_gene_threshold: int = 1000000,
    regression_dir: str = "",
    sample_names: Optional[List[str]] = None,
    snarl_chunk_size: int = 8192,
    secondary: Optional[Dict] = None,
    resume: bool = False,
) -> int:
    """Run the GWAS over a VCF on ``device``; returns the number of snarls
    filtered (in the primary output).  ``phenotype`` is the mode's input:

      "binary"        bool [N] (chi-squared and Fisher)
      "binary_covar"  the same, for logistic regression (the covariates
                      were validated by the caller and stay out of the
                      model, as in the reference)
      "quantitative"  float64 [N], OLS with the optional [N, C] covariates
      "lmm"           an ``stats.lmm.LmmContext`` (the mixed model; the
                      covariates join its designs)
      "eqtl"          {chrom: [io.phenotype.QtlData]}, OLS of each gene's
                      expression within ``windows_gene_threshold`` of a
                      snarl, with the covariates

    ``secondary`` tests a second phenotype in the same pass into a second
    table (stoat_tpu, :440-446): a dict with ``mode`` (binary,
    binary_covar, quantitative or lmm), ``output_tsv`` and the mode's
    phenotype under ``binary_phenotype``, ``quantitative_phenotype`` or
    ``lmm_ctx``; not with an eQTL primary.  ``table_threshold`` other than
    -1 (the CLI's -T) writes the regression modes' significant tables into
    ``regression_dir``, which the caller has made, with the columns named
    by ``sample_names``.  Each output is byte-identical to stoat_tpu's
    run_vcf_analysis with the same arguments."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    if secondary is not None:
        if mode == "eqtl":
            raise ValueError("secondary phenotype runs do not support eQTL "
                             "primaries")
        _validate_secondary(secondary)
    header_reader = VcfReader(vcf_path)
    samples = sample_names or header_reader.samples
    header_reader.close()
    n_hap = 2 * len(samples)
    if mode != "binary" and samples:
        # the [chunk, samples, 1 + Pmax + C] float64 design stays near
        # 2 GB (stoat_tpu/pipeline/runner.py:598-605)
        snarl_chunk_size = min(snarl_chunk_size,
                               max(int(2e9 // (len(samples) * 96)), 256))

    # --resume: a chromosome counts as complete once every output of the
    # run has its progress entry; each output truncates back to the last
    # jointly complete offset, so a partially written chromosome is
    # rewritten whole (stoat_tpu, :495-537).
    resume_done: List[str] = []
    prim_prog = sec_prog = None
    if resume:
        prim_prog = _read_progress(output_tsv)
        sec_prog = (_read_progress(secondary["output_tsv"])
                    if secondary is not None else None)
        for c in prim_prog:
            if sec_prog is None or c in sec_prog:
                resume_done.append(c)
            else:
                break
        if resume_done:
            logger.info("Resume: %d chromosome(s) already complete (%s)",
                        len(resume_done), ", ".join(resume_done))

    def _open_output(path, m, prog):
        if resume_done and prog is not None:
            fh = open(path, "r+", newline="")
            fh.seek(prog[resume_done[-1]])
            fh.truncate()
            return fh
        try:
            os.remove(_progress_path(path))
        except OSError:
            pass
        fh = open(path, "w", newline="")
        if m == "binary":
            W.write_binary_header(fh)
        elif m == "binary_covar":
            W.write_binary_covar_header(fh)
        elif m == "eqtl":
            W.write_eqtl_header(fh)
        else:
            W.write_quantitative_header(fh)
        return fh

    run = _Run(mode, phenotype, covariate, device,
               (min_individuals, min_haplotypes, maf_threshold),
               snarl_chunk_size, windows_gene_threshold, table_threshold,
               regression_dir, samples, secondary)
    total_analyzed = total_filtered = 0
    with _open_output(output_tsv, mode, prim_prog) as outf:
        if secondary is not None:
            run.sec_fh = _open_output(secondary["output_tsv"],
                                      secondary["mode"], sec_prog)
        matrices = _prefetched(iter_chromosome_matrices(
            vcf_path, n_hap, snarls_chr))
        tokenizer = _QuadTokenizer(snarls_chr)
        writer = None if mode == "eqtl" else _PipelinedWriter()
        try:
            for chrom, matrix in matrices:
                if chrom not in snarls_chr:
                    logger.warning("Chromosome %s not found in snarl paths "
                                   "file. Skipping.", chrom)
                    continue
                if chrom in resume_done:
                    logger.info("Resume: chromosome %s already complete; "
                                "skipping.", chrom)
                    continue
                snarls = snarls_chr[chrom]
                total_filtered += _dispatch_chromosome(
                    outf, output_tsv, chrom, matrix, snarls, writer,
                    tokenizer, run)
                total_analyzed += len(snarls)
        finally:
            # join the writer even when the dispatch failed, so no row is
            # written after the file is closed
            if writer is not None:
                counts = writer.close()
                total_filtered += counts.get("primary", 0)
                if secondary is not None:
                    logger.info("Secondary mode: %d snarls filtered",
                                counts.get("secondary", 0))
            if run.sec_fh is not None:
                run.sec_fh.close()
    logger.info("Total number of snarl filtered : %d", total_filtered)
    if total_analyzed and total_filtered == total_analyzed:
        logger.warning(
            "All %d snarls across every chromosome were filtered — the "
            "output table has a header and no rows. Check that the VCF "
            "carries AT INFO fields matching the snarl file's paths and "
            "that the filter thresholds fit the cohort size.",
            total_analyzed)
    return total_filtered
