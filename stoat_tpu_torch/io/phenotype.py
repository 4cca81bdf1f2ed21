"""Phenotype / covariate / eQTL / kinship file parsing.

Format and error-message parity with the reference's src/arg_parser.cpp:
  - binary phenotype ``FID IID PHENO`` with 1=control, 2=case (:20-95)
  - quantitative phenotype ``FID IID PHENO`` float (:96-150)
  - covariates: whitespace table with an IID column and named covariate
    columns, reordered to the VCF sample order (:341-419)
  - eQTL: gene×sample expression matrix + gene positions file (:207-338)
  - kinship: header of IDs + square matrix (:444-475) — parsed but unused
    by the reference (the LMM is a stub); kept for interface parity
  - chromosome-reference list: one path name per line (:8-19)
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("stoat")

__all__ = [
    "parse_binary_pheno",
    "parse_quantitative_pheno",
    "parse_covariates",
    "parse_chromosome_reference",
    "parse_qtl_gene_file",
    "parse_kinship_matrix",
    "QtlData",
    "KinshipMatrix",
]


def _check_match_samples(mapping: dict, keys: List[str]) -> None:
    """arg_parser.cpp:194-204."""
    for key in keys:
        if key not in mapping:
            raise ValueError(f"Sample '{key}' not found in the phenotype file")
    if len(mapping) != len(keys):
        logger.warning(
            "Number of samples found in VCF (%d) does not match the number "
            "of samples in the phenotype file (%d).", len(keys), len(mapping))


def parse_binary_pheno(file_path: str,
                       list_samples: List[str]) -> Tuple[np.ndarray, List[str]]:
    """Parse a plink-style binary phenotype file.

    Returns (phenotype bool array aligned to list_samples, list_samples) —
    if ``list_samples`` is empty it is filled from the file order
    (arg_parser.cpp:23-26,69-71).
    """
    fill_in = len(list_samples) == 0
    samples = list(list_samples)
    pheno: Dict[str, bool] = {}
    n_cases = n_controls = 0
    with open(file_path) as fh:
        header = fh.readline().split()
        if header[:3] != ["FID", "IID", "PHENO"]:
            raise ValueError(f"Invalid header: {' '.join(header)}")
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 3:
                raise ValueError(f"Malformed line: {line.rstrip()}")
            _fid, iid, pheno_str = parts[0], parts[1], parts[2]
            try:
                value = int(pheno_str)
            except ValueError:
                raise ValueError(f"Bad phenotype type: {pheno_str}")
            if value == 1:
                n_controls += 1
                pheno[iid] = False
            elif value == 2:
                n_cases += 1
                pheno[iid] = True
            else:
                raise ValueError(
                    f"Binary phenotype must be 1 or 2, got: {value}")
            if fill_in:
                samples.append(iid)
    logger.info("Binary phenotypes found: %d (Control: %d, Case: %d)",
                n_controls + n_cases, n_controls, n_cases)
    if not fill_in:
        _check_match_samples(pheno, samples)
    values = np.array([pheno[s] for s in samples if s in pheno], dtype=bool)
    return values, samples


def parse_quantitative_pheno(file_path: str,
                             list_samples: List[str]) -> np.ndarray:
    pheno: Dict[str, float] = {}
    with open(file_path) as fh:
        header = fh.readline().split()
        if header[:3] != ["FID", "IID", "PHENO"]:
            raise ValueError(
                f"In parsing phenotype, invalid header: {' '.join(header)}")
        count = 0
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 3:
                raise ValueError(
                    f"In parsing phenotype, malformed line: {line.rstrip()}")
            try:
                pheno[parts[1]] = float(parts[2])
            except ValueError:
                raise ValueError(f"Bad phenotype type: {parts[2]}")
            count += 1
    logger.info("Quantitative phenotypes found: %d", count)
    _check_match_samples(pheno, list_samples)
    return np.array([pheno[s] for s in list_samples if s in pheno],
                    dtype=np.float64)


def parse_covariates(file_path: str, covar_names: List[str],
                     list_samples: List[str]) -> np.ndarray:
    """Select named covariate columns, ordered by the VCF sample list.

    Returns [n_samples, n_covariates] float64 (arg_parser.cpp:341-419).
    """
    with open(file_path) as fh:
        headers = fh.readline().split()
        if "IID" not in headers:
            raise ValueError("header must include 'IID' column.\n")
        iid_index = headers.index("IID")
        col_index = {h: i for i, h in enumerate(headers)}
        for name in covar_names:
            if name not in col_index:
                raise ValueError(
                    f"covariate column '{name}' not found in file.\n")
        covar_map: Dict[str, List[float]] = {}
        for line in fh:
            tokens = line.split()
            if len(tokens) <= iid_index:
                continue
            iid = tokens[iid_index]
            try:
                covar_map[iid] = [float(tokens[col_index[n]])
                                  for n in covar_names]
            except ValueError:
                raise ValueError(f"Individual {iid} got an non-numeric value\n")
            except IndexError:
                raise ValueError(
                    f"Individual {iid}: line has fewer columns than "
                    "the header\n")
    _check_match_samples(covar_map, list_samples)
    rows = []
    for sample in list_samples:
        if sample not in covar_map:
            raise ValueError(
                f"Sample {sample} not found in the covariate file.")
        rows.append(covar_map[sample])
    return np.array(rows, dtype=np.float64)


def parse_chromosome_reference(file_path: str) -> set:
    """One reference path name per line (arg_parser.cpp:8-19)."""
    with open(file_path) as fh:
        return {line.rstrip("\n") for line in fh if line.rstrip("\n")}


@dataclass
class QtlData:
    """Per-gene expression + position (arg_parser.hpp Qtl_data)."""

    gene_name: str
    sample_expression: np.ndarray
    start_pos: int
    end_pos: int


def parse_gene_positions(file_path: str) -> Dict[str, Tuple[str, int, int]]:
    gene_map: Dict[str, Tuple[str, int, int]] = {}
    with open(file_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        if header[:4] != ["gene_name", "chr", "start", "end"]:
            raise ValueError(
                "In parsing gene position file, invalid header. "
                "Expected: gene_name\tchr\tstart\tend")
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 4:
                raise ValueError(
                    f"In parsing gene position file, malformed line: {line}")
            try:
                gene_map[cols[0]] = (cols[1], int(cols[2]), int(cols[3]))
            except ValueError:
                raise ValueError(
                    "In parsing gene position file, invalid numeric value "
                    f"in line: {line}")
    return gene_map


def parse_qtl_file(file_path: str,
                   list_samples: List[str]) -> Dict[str, np.ndarray]:
    with open(file_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        sample_names = header[1:]
        sample_set = set(list_samples)
        for sample in sample_names:
            if sample not in sample_set:
                raise ValueError(
                    f"Sample {sample} not found in the list of samples.")
        if len(sample_names) != len(list_samples):
            logger.warning("Number of samples in the QTL file does not match "
                           "the number of samples in the VCF.")
        expressions: Dict[str, np.ndarray] = {}
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            try:
                expressions[cols[0]] = np.array(
                    [float(v) for v in cols[1:]], dtype=np.float64)
            except ValueError:
                raise ValueError(
                    f"Invalid expression value for gene {cols[0]}")
    return expressions


def parse_qtl_gene_file(eqtl_path: str, gene_position_path: str,
                        list_samples: List[str]) -> Dict[str, List[QtlData]]:
    """Join expression matrix with gene positions into per-chromosome lists
    (arg_parser.cpp:207-236)."""
    qtl = parse_qtl_file(eqtl_path, list_samples)
    gene_position = parse_gene_positions(gene_position_path)
    qtl_map: Dict[str, List[QtlData]] = {}
    for gene, expr in qtl.items():
        if gene not in gene_position:
            raise ValueError(f"Gene {gene} not found in gene positions.")
        chrom, start, end = gene_position[gene]
        qtl_map.setdefault(chrom, []).append(QtlData(gene, expr, start, end))
    if len(gene_position) > len(qtl):
        logger.warning(
            "More genes present in the gene position file than in the QTL file.")
    return qtl_map


@dataclass
class KinshipMatrix:
    ids: List[str]
    matrix: np.ndarray


def parse_kinship_matrix(file_path: str) -> KinshipMatrix:
    """arg_parser.cpp:444-475 — parsed-but-unused in the reference (LMM is
    declared, not implemented; stats_test.hpp:115-125)."""
    with open(file_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        ids = header[1:]
        rows = []
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            rows.append([float(v) for v in cols[1:]])
    return KinshipMatrix(ids=ids, matrix=np.array(rows, dtype=np.float64))
