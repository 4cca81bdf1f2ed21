"""stoat_tpu_torch: the PyTorch/CUDA port of stoat-tpu.

A second package beside ``stoat_tpu`` (the JAX reference, unchanged).  It
imports ``torch`` and nothing of ``jax`` or ``stoat_tpu``: its host layers
are its own copies of the JAX package's host modules, under the same
names: the parsers (``io``), the edge matrix and table packing
(``matrix``, ``tables``), the native C++ cores (``native``, built into
build/stoat_tpu_torch/native/), the writers, the graph readers and the
decomposition (``graph``).  What ran as jitted XLA programs on the TPU
runs here as hand-written CUDA kernels for Hopper (sm_90a) on a CUDA
device, or as their plain PyTorch versions on the CPU:

- ``pipeline/packed.py``: K1+K2, gather-AND membership + popcount counts
  (csrc/membership_counts.cu);
- ``pipeline/binary.py``: K3, per-snarl table, filter and chi-squared
  statistic (csrc/binary_tables.cu), K3 and K4 in one launch
  (csrc/binary_stats.cu), and K1+K2, K3 and K4 in one launch, the main
  path's (csrc/binary_stats.cu's binary_from_words);
- ``stats/fisher.py``: K4, the Fisher exact scan (csrc/fisher.cu);
- ``stats/special.py``: K5, the chi-squared tail (csrc/chi2_tail.cu);
- ``pipeline/quantitative.py``: K1+K7+K8, per-snarl OLS designs straight
  from the packed words (csrc/quant_design.cu);
- ``stats/linreg.py``: K9, masked OLS with the LDL^T rank probe and the
  Jacobi pseudo-inverse (csrc/ols.cu), and K10, the Student-t tail and
  the NA masking (csrc/student_t.cu);
- ``graph/association.py``: K6, graph mode's statistics and their
  chi-squared tails (csrc/graph_stats.cu);
- ``stats/logreg.py``: K11, IRLS logistic regression (csrc/logreg.cu);
- ``pipeline/permutation.py``: K15 and K16, the permutation test's
  membership, tables and statistics (csrc/perm_binary.cu), OLS t over the
  permuted phenotypes (csrc/perm_ols.cu) and the covariate-adjusted
  score test (csrc/score_test.cu).

Every command of stoat_tpu runs here: ``vcf`` in each of its modes
(``-b``, ``-q``, both, ``-b -c``, ``-q -c``, eQTL, ``--lmm``, with
``--permutations N``, ``-T`` and ``-g``), ``graph``, and the host-only
``BHcorrect``, ``simulate``, ``truth`` and ``plot``: ``python -m
stoat_tpu_torch <command> ...`` writes the same files as ``python -m
stoat_tpu <command> ...`` (``plot``: the same file names).  ``vcf`` runs
on one device, or with its chunks dealt over several (``parallel``: the
snarl mesh, each chunk on the kernels above on its own device; ``vcf
--device cuda`` takes every visible card when there are several).
ROADMAP.md lists what is still to port: the benchmark.
"""

__version__ = "0.3.0"
