"""Output TSV writers — byte-parity with the reference's src/writer.cpp.

The port's copy of stoat_tpu/writer.py: the ``vcf`` tables (binary,
binary with covariates, quantitative) and graph mode's rows are written
here, in batches through the port's native formatters (native/
stoat_core.cpp) or row by row in Python; the permutation tables reuse
:func:`format_p`.  Column layouts (writer.cpp:7-21):
  binary:       #CHR START_POS END_POS SNARL PATH_LENGTHS P_FISHER P_CHI2 GROUP_PATHS DEPTH
  binary+covar: #CHR START_POS END_POS SNARL PATH_LENGTHS P BETA SE ALLELE_PATHS DEPTH
  quantitative: #CHR START_POS END_POS SNARL PATH_LENGTHS P RSQUARE BETA SE ALLELE_PATHS DEPTH
  eQTL:         #CHR START_POS END_POS SNARL PATH_LENGTHS GENE P RSQUARE BETA SE ALLELE_PATHS DEPTH
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from stoat_tpu_torch.formatting import set_precision
from stoat_tpu_torch.io.snarl_file import SnarlData, SnarlTable

__all__ = [
    "format_p",
    "format_group_paths",
    "write_binary_header", "write_binary_row",
    "write_binary_covar_header", "write_binary_covar_row",
    "write_quantitative_header", "write_quantitative_row",
    "write_eqtl_header", "write_eqtl_row",
    "write_significant_table",
    "write_binary_rows_batch", "write_quant_rows_batch",
    "write_eqtl_rows_batch",
]

BINARY_HEADER = ("#CHR\tSTART_POS\tEND_POS\tSNARL\tPATH_LENGTHS\tP_FISHER\t"
                 "P_CHI2\tGROUP_PATHS\tDEPTH\n")
BINARY_COVAR_HEADER = ("#CHR\tSTART_POS\tEND_POS\tSNARL\tPATH_LENGTHS\tP\t"
                       "BETA\tSE\tALLELE_PATHS\tDEPTH\n")
QUANTITATIVE_HEADER = ("#CHR\tSTART_POS\tEND_POS\tSNARL\tPATH_LENGTHS\tP\t"
                       "RSQUARE\tBETA\tSE\tALLELE_PATHS\tDEPTH\n")
EQTL_HEADER = ("#CHR\tSTART_POS\tEND_POS\tSNARL\tPATH_LENGTHS\tGENE\tP\t"
               "RSQUARE\tBETA\tSE\tALLELE_PATHS\tDEPTH\n")


def format_p(value: float) -> str:
    """Render a kernel p-value/statistic: NaN becomes "NA"."""
    if value != value:
        return "NA"
    return set_precision(value)


def format_group_paths(g0: Sequence[int], g1: Sequence[int]) -> str:
    """``g0:g1,g0:g1,...`` (binary_table.cpp:6-17)."""
    return ",".join(f"{int(a)}:{int(b)}" for a, b in zip(g0, g1))


def write_binary_header(fh) -> None:
    fh.write(BINARY_HEADER)


def write_binary_row(fh, chrom: str, snarl: SnarlData, type_var_str: str,
                     p_fisher: str, p_chi2: str, group_paths: str) -> None:
    fh.write(f"{chrom}\t{snarl.start_pos}\t{snarl.end_pos}\t"
             f"{snarl.snarl_id_str}\t{type_var_str}\t{p_fisher}\t{p_chi2}\t"
             f"{group_paths}\t{snarl.depth}\n")


def write_binary_covar_header(fh) -> None:
    fh.write(BINARY_COVAR_HEADER)


def write_binary_covar_row(fh, chrom: str, snarl: SnarlData,
                           type_var_str: str, p: str, beta: str, se: str,
                           allele_paths: Sequence[int]) -> None:
    ap = ",".join(str(int(x)) for x in allele_paths)
    fh.write(f"{chrom}\t{snarl.start_pos}\t{snarl.end_pos}\t"
             f"{snarl.snarl_id_str}\t{type_var_str}\t{p}\t{beta}\t{se}\t"
             f"{ap}\t{snarl.depth}\n")


def write_quantitative_header(fh) -> None:
    fh.write(QUANTITATIVE_HEADER)


def write_quantitative_row(fh, chrom: str, snarl: SnarlData,
                           type_var_str: str, p: str, r2: str, beta: str,
                           se: str, allele_paths: Sequence[int]) -> None:
    ap = ",".join(str(int(x)) for x in allele_paths)
    fh.write(f"{chrom}\t{snarl.start_pos}\t{snarl.end_pos}\t"
             f"{snarl.snarl_id_str}\t{type_var_str}\t{p}\t{r2}\t{beta}\t{se}\t"
             f"{ap}\t{snarl.depth}\n")


def write_eqtl_header(fh) -> None:
    fh.write(EQTL_HEADER)


def write_eqtl_row(fh, chrom: str, snarl: SnarlData, type_var_str: str,
                   gene: str, p: str, r2: str, beta: str, se: str,
                   allele_paths: Sequence[int]) -> None:
    ap = ",".join(str(int(x)) for x in allele_paths)
    fh.write(f"{chrom}\t{snarl.start_pos}\t{snarl.end_pos}\t"
             f"{snarl.snarl_id_str}\t{type_var_str}\t{gene}\t{p}\t{r2}\t"
             f"{beta}\t{se}\t{ap}\t{snarl.depth}\n")


def write_significant_table(path: str, table: np.ndarray,
                            path_names: List[str],
                            sample_names: List[str]) -> None:
    """Per-snarl sample×path dosage dump for significant hits
    (writer.cpp:181-208)."""
    with open(path, "w") as fh:
        fh.write("sample_name")
        for name in path_names:
            fh.write("\t" + name)
        fh.write("\n")
        for sample, row in zip(sample_names, table):
            fh.write(sample)
            for value in row:
                fh.write(f"\t{value:g}")
            fh.write("\n")


def _chunk_meta(snarls):
    """A chunk's row prefixes (NUL-terminated), depths and path counts,
    read from its snarls' columns (:class:`SnarlTable`)."""
    table = SnarlTable.of(snarls)
    return table.row_prefixes(), table.depth, table.n_paths


def _write_blob(fh, blob: bytes) -> None:
    """Write formatted bytes, bypassing the text layer's re-encode when
    the stream exposes a binary buffer."""
    buf = getattr(fh, "buffer", None)
    if buf is not None:
        fh.flush()
        buf.write(blob)
    else:
        fh.write(blob.decode())


def write_binary_rows_batch(fh, chrom: str, snarls, res) -> int:
    """Write all of a chunk's binary rows; returns the filtered count.

    One C++ batch-format call + one fh.write (the per-row Python loop is
    the writer's hot path at scale); value-identical fallback to the
    per-row path when the native core is unavailable (pinned by tests).
    """
    S = len(snarls)
    filtered_arr = np.asarray(res["filtered"])[:S]
    n_filtered = int(np.sum(filtered_arr))
    try:
        from stoat_tpu_torch import native
        prefixes, depths, _np_arr = _chunk_meta(snarls)
        blob = native.format_binary_rows(
            chrom, prefixes, depths,
            filtered_arr, np.asarray(res["p_fisher"])[:S],
            np.asarray(res["p_chi2"])[:S], np.asarray(res["g0"])[:S],
            np.asarray(res["g1"])[:S], np.asarray(res["keep"])[:S], S)
    except (OSError, AttributeError):
        blob = None
    if blob is not None:
        _write_blob(fh, blob)
        return n_filtered
    # hoist the array conversions: per-row np.asarray over the whole
    # result arrays was O(S) conversions (and O(S) wire fetches for
    # lazy results) per chunk
    keep_arr = np.asarray(res["keep"])
    g0_arr = np.asarray(res["g0"])
    g1_arr = np.asarray(res["g1"])
    pf_arr = np.asarray(res["p_fisher"])
    pc_arr = np.asarray(res["p_chi2"])
    for s, snarl in enumerate(snarls):
        if filtered_arr[s]:
            continue
        keep = keep_arr[s]
        write_binary_row(fh, chrom, snarl, snarl.type_var_str,
                         format_p(float(pf_arr[s])),
                         format_p(float(pc_arr[s])),
                         format_group_paths(
                             g0_arr[s][keep].astype(np.int64),
                             g1_arr[s][keep].astype(np.int64)))
    return n_filtered


def write_quant_rows_batch(fh, chrom: str, snarls, res,
                           has_r2: bool = True) -> int:
    """Write a chunk's quantitative/covar rows; returns filtered count."""
    S = len(snarls)
    filtered_arr = np.asarray(res["filtered"])[:S]
    n_filtered = int(np.sum(filtered_arr))
    drop = filtered_arr
    try:
        from stoat_tpu_torch import native
        prefixes, depths, n_paths = _chunk_meta(snarls)
        blob = native.format_quant_rows(
            chrom, prefixes, depths,
            drop, np.asarray(res["p"])[:S],
            np.asarray(res["r2"])[:S] if has_r2 else None,
            np.asarray(res["beta"])[:S], np.asarray(res["se"])[:S],
            np.asarray(res["allele_paths"])[:S],
            n_paths, S, has_r2)
    except (OSError, AttributeError):
        blob = None
    if blob is not None:
        _write_blob(fh, blob)
        return n_filtered
    allele_arr = np.asarray(res["allele_paths"])
    p_arr = np.asarray(res["p"])
    r2_arr = np.asarray(res["r2"]) if has_r2 else None
    beta_arr = np.asarray(res["beta"])
    se_arr = np.asarray(res["se"])
    for s, snarl in enumerate(snarls):
        if drop[s]:
            continue
        p_str = format_p(float(p_arr[s]))
        ap = allele_arr[s][: snarl.n_paths]
        if has_r2:
            write_quantitative_row(
                fh, chrom, snarl, snarl.type_var_str, p_str,
                format_p(float(r2_arr[s])),
                format_p(float(beta_arr[s])),
                format_p(float(se_arr[s])), ap)
        else:
            write_binary_covar_row(
                fh, chrom, snarl, snarl.type_var_str, p_str,
                format_p(float(beta_arr[s])),
                format_p(float(se_arr[s])), ap)
    return n_filtered


def write_eqtl_rows_batch(fh, chrom: str, snarls, gene_names: Sequence[str],
                          pair_snarl, pair_gene, res, allele_paths) -> None:
    """Write a chunk's eQTL rows, one a (snarl, gene) pair in pair order:
    pair b is ``snarls[pair_snarl[b]]`` with gene
    ``gene_names[pair_gene[b]]``, its p, r2, beta and se from ``res``, the
    snarl's allele counts from ``allele_paths`` [S, Pmax].  One C++
    batch-format call and one write; the per-row path
    (:func:`write_eqtl_row`), whose bytes it equals, where the native core
    is unavailable."""
    p, r2, beta, se = (np.asarray(res[k]) for k in ("p", "r2", "beta", "se"))
    allele_arr = np.asarray(allele_paths)
    try:
        from stoat_tpu_torch import native
        prefixes, depths, n_paths = _chunk_meta(snarls)
        genes = "".join(g + "\0" for g in gene_names).encode()
        blob = native.format_eqtl_rows(
            chrom, prefixes, depths, allele_arr[:len(snarls)], n_paths,
            genes, len(gene_names), pair_snarl, pair_gene, p, r2, beta, se)
    except (OSError, AttributeError):
        blob = None
    if blob is not None:
        _write_blob(fh, blob)
        return
    for b, (s, g) in enumerate(zip(pair_snarl, pair_gene)):
        snarl = snarls[s]
        write_eqtl_row(fh, chrom, snarl, snarl.type_var_str, gene_names[g],
                       format_p(float(p[b])), format_p(float(r2[b])),
                       format_p(float(beta[b])), format_p(float(se[b])),
                       allele_arr[s][: snarl.n_paths])
