"""Snarl-sharded execution over several devices (the port of
stoat_tpu/parallel).

The reference's only parallelism is OpenMP threads over snarls
(the reference's src/snarl_analyzer.cpp:165).  The JAX package made it
data parallelism over the snarl axis: a 1-D device mesh, the edge x
haplotype words and the phenotype replicated, per-shard results gathered
back to the host for output and BH post-processing.  The port keeps the
layout and runs each shard on the single-device kernels of its own device
(mesh.py, sharded.py).
"""

from stoat_tpu_torch.parallel.mesh import (
    make_snarl_mesh,
    shard_chromosome_chunks,
    shard_packed_chromosome,
    ShardedChromosome,
)
from stoat_tpu_torch.parallel.sharded import (ShardedPermState,
                                              binary_analyze_sharded,
                                              binary_covar_analyze_sharded,
                                              binary_perm_pvalues_sharded,
                                              dual_analyze_sharded,
                                              eqtl_regress_pairs_sharded,
                                              lmm_analyze_sharded,
                                              logistic_score_perm_sharded,
                                              quant_perm_pvalues_sharded,
                                              quantitative_analyze_sharded)

__all__ = [
    "make_snarl_mesh",
    "shard_packed_chromosome",
    "shard_chromosome_chunks",
    "ShardedChromosome",
    "binary_analyze_sharded",
    "binary_covar_analyze_sharded",
    "dual_analyze_sharded",
    "lmm_analyze_sharded",
    "quantitative_analyze_sharded",
    "eqtl_regress_pairs_sharded",
    "binary_perm_pvalues_sharded",
    "quant_perm_pvalues_sharded",
    "logistic_score_perm_sharded",
    "ShardedPermState",
]
