"""Streaming VCF reader (text or bgzip/gzip) for the GWAS pipeline.

Replaces the reference's htslib streaming (arg_parser.cpp:153-186,
snarl_analyzer.cpp:190-260) with a host-side Python reader; the hot
ingestion loop has a C-accelerated path in ``stoat_tpu_torch.native`` when the
extension is built.

Per record the pipeline needs:
  - CHROM
  - INFO ``LV`` (skip record when present and != 0 — nested variants would
    double-count snarls; snarl_analyzer.cpp:199-208)
  - INFO ``AT`` comma-separated allele traversals (``>123>213<234``)
  - per-sample diploid GT allele indices, -1 for missing
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["VcfReader", "VcfRecord", "parse_gt_fields"]


class VcfRecord:
    __slots__ = ("chrom", "pos", "alleles", "at_paths")

    def __init__(self, chrom: str, pos: int, alleles: np.ndarray,
                 at_paths: List[str]):
        self.chrom = chrom
        self.pos = pos
        self.alleles = alleles        # [2 * n_samples] int32, -1 = missing
        self.at_paths = at_paths      # allele index -> traversal string


def _open_text(path: str):
    if path.endswith(".gz") or path.endswith(".bgz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r")


def parse_gt_fields(sample_fields: List[str]) -> np.ndarray:
    """Parse diploid GT strings to a flat [2N] int array (-1 = missing).

    Accepts ``0/1``, ``0|1``, ``.``, ``./.``, and GT-first composite fields
    like ``0/1:12``; haploid calls get allele2 = -1 (matching htslib's
    vector-end semantics as consumed at snarl_analyzer.cpp:237-252).
    """
    out = np.full(2 * len(sample_fields), -1, dtype=np.int32)
    for i, field in enumerate(sample_fields):
        gt = field
        colon = gt.find(":")
        if colon >= 0:
            gt = gt[:colon]
        if not gt or gt == ".":
            continue
        sep = "/" if "/" in gt else ("|" if "|" in gt else None)
        if sep is None:
            if gt != ".":
                try:
                    out[2 * i] = int(gt)
                except ValueError:
                    pass
            continue
        a1, _, a2 = gt.partition(sep)
        if a1 and a1 != ".":
            try:
                out[2 * i] = int(a1)
            except ValueError:
                pass
        if a2 and a2 != ".":
            try:
                out[2 * i + 1] = int(a2)
            except ValueError:
                pass
    return out


def _info_field(info: str, key: str) -> Optional[str]:
    """Extract ``key=value`` from a semicolon-joined INFO column."""
    if info == "." or not info:
        return None
    for part in info.split(";"):
        if part.startswith(key):
            rest = part[len(key):]
            if rest.startswith("="):
                return rest[1:]
            if rest == "":
                return ""
    return None


class VcfReader:
    """Iterates VCF records grouped by chromosome, like the reference's
    per-chromosome chunking (snarl_analyzer.cpp:124-159)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = _open_text(path)
        self.samples: List[str] = []
        self._pushback: Optional[VcfRecord] = None
        self._read_header()

    def _read_header(self) -> None:
        for line in self._fh:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                self.samples = cols[9:]
                return
            raise ValueError("Could not read VCF header")
        raise ValueError("Could not read VCF header")

    def _parse_line(self, line: str) -> Optional[VcfRecord]:
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 10:
            return None
        chrom, pos_s, _vid, _ref, _alt, _qual, _filt, info = cols[:8]
        lv = _info_field(info, "LV")
        if lv is not None and lv != "" and int(lv) != 0:
            return None  # nested variant, skip (snarl_analyzer.cpp:203-208)
        at = _info_field(info, "AT")
        at_paths = at.split(",") if at else []
        alleles = parse_gt_fields(cols[9:])
        return VcfRecord(chrom, int(pos_s), alleles, at_paths)

    def _next_record(self) -> Optional[VcfRecord]:
        if self._pushback is not None:
            rec, self._pushback = self._pushback, None
            return rec
        for line in self._fh:
            if line.startswith("#") or not line.strip():
                continue
            rec = self._parse_line(line)
            if rec is not None:
                return rec
        return None

    def chromosome_chunks(self) -> Iterator[Tuple[str, List[VcfRecord]]]:
        """Yield (chrom, records) in file order, one chromosome at a time."""
        current: List[VcfRecord] = []
        current_chrom: Optional[str] = None
        while True:
            rec = self._next_record()
            if rec is None:
                break
            if current_chrom is None:
                current_chrom = rec.chrom
            if rec.chrom != current_chrom:
                yield current_chrom, current
                current = []
                current_chrom = rec.chrom
            current.append(rec)
        if current_chrom is not None:
            yield current_chrom, current

    def close(self) -> None:
        self._fh.close()
