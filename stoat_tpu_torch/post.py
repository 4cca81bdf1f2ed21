"""Benjamini–Hochberg post-processing of result TSVs.

The port's copy of stoat_tpu/post.py (the ``BHcorrect`` subcommand).
Equivalent of add_BH_adjusted_column
(the reference's src/post_processing.cpp:41-155): read a results TSV,
BH-adjust the p column, rewrite the file with the adjusted column replaced,
and emit a "significant" file with rows whose adjusted p < 1e-5.

Column conventions (post_processing.cpp:49-53, 1-indexed in the reference
CLI, 0-indexed here): BINARY/EQTL -> adjusted col 7, QUANT/BINARY_COVAR ->
adjusted col 6; p column is always adjusted_col - 1.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from stoat_tpu_torch.corrections import adjust_pvalues_bh
from stoat_tpu_torch.formatting import set_precision, string_to_pvalue

__all__ = ["add_bh_adjusted_column", "adjusted_column_for_mode"]

SIGNIFICANCE_THRESHOLD = 1e-5  # post_processing.cpp:138


def adjusted_column_for_mode(mode: str) -> int:
    """0-indexed adjusted-p column per phenotype mode.

    The reference's map (post_processing.cpp:41-56) is 1-indexed:
    column 7 for BINARY (P_CHI2) / EQTL (P), column 6 for QUANT /
    BINARY_COVAR (P); converted here to the 0-indexed convention this
    module uses (binary layout: ...5 P_FISHER, 6 P_CHI2...; quant:
    ...5 P...)."""
    if mode in ("binary", "eqtl"):
        return 6
    if mode in ("quantitative", "binary_covar"):
        return 5
    raise ValueError(f"unknown mode {mode}")


def add_bh_adjusted_column(input_file: str, output_dir: str,
                           output_file_significant: str,
                           p_col_index: int, adjusted_col_index: int) -> None:
    with open(input_file) as fh:
        header_line = fh.readline().rstrip("\n")
        rows = [line.rstrip("\n").split("\t") for line in fh
                if line.rstrip("\n")]

    pvals = np.array([string_to_pvalue(r[p_col_index]) for r in rows])
    adjusted = adjust_pvalues_bh(pvals) if len(pvals) else pvals

    # temp file NEXT TO the input: os.replace across filesystems (a -o
    # dir on another mount) raises EXDEV after the rewrite completed
    tmp = input_file + ".bh_tmp"
    with open(tmp, "w") as out, open(output_file_significant, "w") as sig:
        out.write(header_line + "\n")
        sig.write(header_line + "\n")
        for row, adj in zip(rows, adjusted):
            row = list(row)
            row[adjusted_col_index] = set_precision(float(adj))
            line = "\t".join(row) + "\n"
            out.write(line)
            if adj < SIGNIFICANCE_THRESHOLD:
                sig.write(line)
    os.replace(tmp, input_file)
