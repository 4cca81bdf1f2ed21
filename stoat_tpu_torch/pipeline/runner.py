"""VCF-mode orchestration on one device: stream -> pack -> device batch ->
TSV, for a binary trait (``-b``, or ``-b -c``: logistic regression) or a
quantitative one (``-q``, with optional covariates).

The port of the single-device binary and quantitative paths of
stoat_tpu/pipeline/runner.py run_vcf_analysis (:412-814).  The VCF is
read one chromosome at a time by the native C++ core on a prefetch
thread; each chromosome's packed words are uploaded once, after the
parse, from pinned memory; its snarls go through the binary or the
quantitative pipeline in chunks; and a writer thread
waits for each chunk's host copies, formats the rows and writes them in
snarl-file order.  ``--resume`` checkpoints every completed chromosome in
a ``<output>.progress`` sidecar.

The helpers below are copies of stoat_tpu/pipeline/runner.py:42-190 and
:284-400: that module imports the JAX pipeline at import time.  The
JAX runner's streamed, deduplicated word uploads (:191-281) existed for a
slow network link and are not ported: uploading after the parse has no
stale rows to patch.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from stoat_tpu import writer as W
from stoat_tpu.io.snarl_file import SnarlData
from stoat_tpu.io.vcf import VcfReader
from stoat_tpu.matrix import EdgeHaplotypeMatrix
from stoat_tpu.tables import pack_chromosome_chunks, tokenize_chromosome
from stoat_tpu_torch.convert import (chunk_words, pheno_masks,
                                     to_binary_pheno, to_quant_inputs,
                                     upload_words)
from stoat_tpu_torch.pipeline.binary import binary_analyze_chromosome
from stoat_tpu_torch.pipeline.quantitative import (
    binary_covar_analyze_chromosome, quantitative_analyze_chromosome)

logger = logging.getLogger("stoat")

__all__ = ["run_vcf_analysis", "iter_chromosome_matrices", "INGEST_COUNTS",
           "MODES"]

MODES = ("binary", "binary_covar", "quantitative")

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
        from stoat_tpu.matrix import PackedEdgeMatrix
        from stoat_tpu.native import NativeVcfMatrixReader
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
    chunk N+1; output order stays deterministic."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self.filtered = 0
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
            try:
                self.filtered += item() or 0
            except BaseException as e:
                self._errors.append(e)

    def count(self) -> int:
        return self.filtered

    def submit(self, fn) -> None:
        if self._errors:
            raise self._errors[0]
        self._q.put(fn)

    def close(self) -> int:
        self._q.put(None)
        self._thread.join()
        if self._errors:
            raise self._errors[0]
        return self.filtered


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
                         tokenizer, mode, phenotype, covariate, device,
                         pheno, min_individuals, min_haplotypes,
                         maf_threshold, snarl_chunk_size):
    """Queue one chromosome's chunks on the device and their writes on
    the writer thread, then its checkpoint; returns the run's phenotype
    tensors (uploaded on the first chunk of the run: the packed masks in
    binary mode, the case indicator in binary_covar mode, the phenotype
    and covariates in quantitative mode)."""
    t0 = time.time()
    logger.info("Analysing chr : %s", chrom)
    _log_degenerate(chrom, matrix, len(snarls))
    chr_state: Dict[str, int] = {}
    writer.submit(lambda: chr_state.__setitem__("start", writer.count()))
    words = None
    for packed in pack_chromosome_chunks(snarls, matrix, snarl_chunk_size,
                                         quad_cache=tokenizer.get(chrom)):
        if words is None:
            # one upload per chromosome: every chunk shares its words
            words = upload_words(chunk_words(packed), device)
        if mode == "binary":
            if pheno is None:
                pheno = pheno_masks(phenotype, packed.n_haplotypes,
                                    int(words.shape[1]), device)
            res = binary_analyze_chromosome(
                packed, phenotype, min_individuals, min_haplotypes,
                maf_threshold, device, words=words, pheno=pheno)
            write = W.write_binary_rows_batch
        elif mode == "binary_covar":
            if pheno is None:
                pheno = to_binary_pheno(phenotype, device)
            res = binary_covar_analyze_chromosome(
                packed, pheno, min_individuals, min_haplotypes,
                maf_threshold, device, words=words)
            write = partial(W.write_quant_rows_batch, has_r2=False)
        else:
            if pheno is None:
                pheno = to_quant_inputs(phenotype, covariate,
                                        packed.n_haplotypes // 2, device)
            res = quantitative_analyze_chromosome(
                packed, *pheno, min_individuals, min_haplotypes,
                maf_threshold, device, words=words)
            write = W.write_quant_rows_batch
        # the writer thread waits for the chunk's host copies, then
        # formats and writes its rows (returns the filtered count)
        writer.submit(partial(write, outf, chrom, packed.snarls, res))

    def _chr_done(n=len(snarls)):
        f = writer.count() - chr_state.get("start", 0)
        if f == n and n:
            logger.warning(
                "Chromosome %s: all %d snarls were filtered "
                "(min-individuals/min-haplotypes/MAF thresholds, or the "
                "snarl paths reference edges absent from the VCF's AT "
                "traversals).", chrom, f)
        logger.info("Number of snarl filtered in chr %s : %d", chrom, f)
        logger.info("Total time for chr %s : %.3f s", chrom,
                    time.time() - t0)
        return 0
    writer.submit(_chr_done)
    # durable checkpoint, strictly after the chromosome's rows (FIFO)
    writer.submit(partial(_record_progress, outf, output_tsv, chrom))
    return pheno


def run_vcf_analysis(
    vcf_path: str,
    snarls_chr: Dict[str, List[SnarlData]],
    output_tsv: str,
    phenotype: np.ndarray,
    device: torch.device,
    mode: str = "binary",
    covariate: Optional[np.ndarray] = None,
    maf_threshold: float = 0.05,
    min_individuals: int = 3,
    min_haplotypes: int = 5,
    sample_names: Optional[List[str]] = None,
    snarl_chunk_size: int = 8192,
    resume: bool = False,
) -> int:
    """Run the GWAS over a VCF on ``device``; returns the number of snarls
    filtered.  ``mode`` "binary" takes a bool phenotype (chi-squared and
    Fisher), "binary_covar" the same phenotype for logistic regression
    (the covariates were validated by the caller and stay out of the
    model, as in the reference), "quantitative" a float64 phenotype and
    optional [N, C] covariates (OLS).  Writes ``output_tsv``
    byte-identical to stoat_tpu's run_vcf_analysis in the same mode."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    header_reader = VcfReader(vcf_path)
    samples = sample_names or header_reader.samples
    header_reader.close()
    n_hap = 2 * len(samples)
    if mode != "binary" and samples:
        # the [chunk, samples, 1 + Pmax + C] float64 design stays near
        # 2 GB (stoat_tpu/pipeline/runner.py:598-605)
        snarl_chunk_size = min(snarl_chunk_size,
                               max(int(2e9 // (len(samples) * 96)), 256))

    # --resume: a chromosome counts as complete once its progress entry
    # exists; the output truncates back to the last complete offset so a
    # partially written chromosome is rewritten whole.
    prog = _read_progress(output_tsv) if resume else {}
    resume_done = list(prog)
    if resume_done:
        logger.info("Resume: %d chromosome(s) already complete (%s)",
                    len(resume_done), ", ".join(resume_done))
        outf = open(output_tsv, "r+", newline="")
        outf.seek(prog[resume_done[-1]])
        outf.truncate()
    else:
        try:
            os.remove(_progress_path(output_tsv))
        except OSError:
            pass
        outf = open(output_tsv, "w", newline="")
        if mode == "binary":
            W.write_binary_header(outf)
        elif mode == "binary_covar":
            W.write_binary_covar_header(outf)
        else:
            W.write_quantitative_header(outf)

    total_analyzed = 0
    with outf:
        matrices = _prefetched(iter_chromosome_matrices(
            vcf_path, n_hap, snarls_chr))
        tokenizer = _QuadTokenizer(snarls_chr)
        writer = _PipelinedWriter()
        pheno = None          # per-run phenotype tensors on device
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
                pheno = _dispatch_chromosome(
                    outf, output_tsv, chrom, matrix, snarls, writer,
                    tokenizer, mode, phenotype, covariate, device, pheno,
                    min_individuals, min_haplotypes, maf_threshold,
                    snarl_chunk_size)
                total_analyzed += len(snarls)
        finally:
            # join the writer even when the dispatch failed, so no row is
            # written after the file is closed
            total_filtered = writer.close()
    logger.info("Total number of snarl filtered : %d", total_filtered)
    if total_analyzed and total_filtered == total_analyzed:
        logger.warning(
            "All %d snarls across every chromosome were filtered — the "
            "output table has a header and no rows. Check that the VCF "
            "carries AT INFO fields matching the snarl file's paths and "
            "that the filter thresholds fit the cohort size.",
            total_analyzed)
    return total_filtered
