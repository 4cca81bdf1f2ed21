"""The port's hand-written CUDA kernels: launcher, checks and launch counts.

Each kernel has a wrapper beside its plain PyTorch version:
``pipeline/packed.py membership_counts`` (csrc/membership_counts.cu),
``pipeline/binary.py binary_tables`` (csrc/binary_tables.cu),
``stats/fisher.py fisher_exact_2x2`` (csrc/fisher.cu),
``stats/special.py chi2_sf`` and ``stats/chi2.py finish_chi2_pvalues``
(csrc/chi2_tail.cu),
``pipeline/quantitative.py quant_design`` (csrc/quant_design.cu; with
``all_rows`` for the mixed model's designs) and ``eqtl_ols_stats``
(csrc/eqtl_ols.cu),
``stats/linreg.py linear_regression_stats`` (csrc/ols.cu),
``stats/linreg.py student_t_pvalues`` and ``linear_pvalues``
(csrc/student_t.cu), ``graph/association.py graph_stats``
(csrc/graph_stats.cu), ``stats/logreg.py logistic_regression``
(csrc/logreg.cu), and the permutation test's
``pipeline/permutation.py perm_membership`` and ``perm_binary_stats``
(csrc/perm_binary.cu), ``perm_ols_stats`` (csrc/perm_ols.cu),
``score_precompute`` and ``score_perm_stats`` (csrc/score_test.cu).  A
wrapper given CUDA tensors launches its kernel through :func:`launch` or
raises; given CPU tensors it runs the plain version.  :data:`LAUNCHES`
counts the launches of each kernel, so that a run can show which kernels
it went through.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

from stoat_tpu_torch.kernels import build

__all__ = ["LAUNCHES", "reset_launch_counts", "check_tensor", "launch",
           "VOIDP", "I64", "F64"]

VOIDP = ctypes.c_void_p
I64 = ctypes.c_int64
F64 = ctypes.c_double

LAUNCHES: Dict[str, int] = {"membership_counts": 0, "binary_tables": 0,
                            "fisher": 0, "quant_design": 0, "ols": 0,
                            "student_t": 0, "graph_stats": 0, "logreg": 0,
                            "perm_membership": 0, "perm_binary": 0,
                            "perm_ols": 0, "score_precompute": 0,
                            "score_perm": 0, "eqtl_ols": 0,
                            "chi2_tail": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_tensor(t, what: str, dtype, shape: Sequence[int], device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what a kernel takes by raw pointer)."""
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def launch(name: str, argtypes: Sequence, args: Sequence, device,
           source: Optional[str] = None) -> None:
    """Call ``<name>_launch(*args, stream)`` of ``csrc/<source>.cu``
    (``source`` defaults to ``name``) on the current stream of ``device``;
    raise if it reports a CUDA error.

    The C function returns ``cudaGetLastError()`` after its launch, so a
    refused launch (bad configuration, no kernel image for the card) is
    reported here rather than lost."""
    import torch

    source = source or name
    lib = build.load(source)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [*argtypes, VOIDP]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        describe = getattr(lib, f"{source}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{err} ({describe(err).decode()})")
    LAUNCHES[name] += 1
