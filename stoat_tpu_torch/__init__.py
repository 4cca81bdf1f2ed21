"""stoat_tpu_torch: the PyTorch/CUDA port of stoat-tpu.

A second package beside ``stoat_tpu`` (the JAX reference, unchanged).  It
imports ``torch`` and never ``jax``.  The host layers that import no JAX
are reused from ``stoat_tpu``: the parsers (``io``), the edge matrix and
table packing (``matrix``, ``tables``), the native C++ core (``native``),
the writers and the graph decomposition.  What ran as jitted XLA programs
on the TPU runs here as hand-written CUDA kernels for Hopper (sm_90a) on a
CUDA device, or as their plain PyTorch versions on the CPU:

- ``pipeline/packed.py``: K1+K2, gather-AND membership + popcount counts
  (csrc/membership_counts.cu);
- ``pipeline/binary.py``: K3, per-snarl table, filter and chi-squared
  statistic (csrc/binary_tables.cu);
- ``stats/fisher.py``: K4, the Fisher exact scan (csrc/fisher.cu);
- ``stats/special.py``: K5, the chi-squared tail (torch.special).

This slice ports ``stoat vcf -b``: a binary trait, no covariates, one
device.  ``python -m stoat_tpu_torch vcf -s SNARLS -v VCF -b PHENO -o OUT
--device cuda`` writes the same ``binary_table_vcf.tsv`` as
``python -m stoat_tpu vcf``.  ROADMAP.md lists what is still to port.
"""

__version__ = "0.3.0"
