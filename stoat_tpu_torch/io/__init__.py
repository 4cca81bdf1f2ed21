"""Host-side input parsing: snarl files, phenotypes, covariates, VCF.

Mirrors the reference's L1 layer (the reference's src/arg_parser.cpp,
snarl_data_t.cpp:8-112) with the same file formats, header contracts and
error semantics.  Parsing stays on host CPU; the parsed products are packed
into dense arrays for the device pipeline by ``stoat_tpu_torch.tables``.
"""

from stoat_tpu_torch.io.snarl_file import SnarlData, parse_snarl_path, parse_path_string
from stoat_tpu_torch.io.phenotype import (
    parse_binary_pheno,
    parse_quantitative_pheno,
    parse_covariates,
    parse_chromosome_reference,
    parse_qtl_gene_file,
    parse_kinship_matrix,
)
from stoat_tpu_torch.io.vcf import VcfReader

__all__ = [
    "SnarlData",
    "parse_snarl_path",
    "parse_path_string",
    "parse_binary_pheno",
    "parse_quantitative_pheno",
    "parse_covariates",
    "parse_chromosome_reference",
    "parse_qtl_gene_file",
    "parse_kinship_matrix",
    "VcfReader",
]
