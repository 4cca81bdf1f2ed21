"""The single-core C++ baseline: the reference's per-snarl scalar loop.

``baseline_core.cpp`` is the benchmark's stand-in for single-core
``stoat``: ``stoat_baseline_run`` runs the binary and quantitative
analyses of each snarl one after the other, ``stoat_baseline_graph``
graph mode's walk-set partition and chi² of each snarl.  Neither touches
the device.  It is built like the port's other cores (g++ at first use
into ``build/stoat_tpu_torch/native/``, named by a key of the source, the
flags and the host CPU), but a failed build raises with the compiler's
output: a benchmark must never time something else in its place.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from stoat_tpu_torch import native
from stoat_tpu_torch.io.snarl_file import path_to_edges

BASELINE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "baseline_core.cpp")
BASELINE_LIBS: Tuple[str, ...] = ()

_lib = None


def get_baseline_lib() -> ctypes.CDLL:
    """The baseline's library, built first when needed; raises
    ``native.NativeBuildError`` (g++'s stderr) when it does not build."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(native.build_library(BASELINE_SRC, BASELINE_LIBS))
    lib.stoat_baseline_run.restype = ctypes.c_long
    lib.stoat_baseline_run.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double)]
    lib.stoat_baseline_graph.restype = ctypes.c_long
    lib.stoat_baseline_graph.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def run_baseline_graph_cpp(steps: np.ndarray, offsets: np.ndarray,
                           start_handles: np.ndarray,
                           pheno: np.ndarray) -> int:
    """Graph mode's single-core loop: the reference's walk-set
    partitioning and chi² of each snarl (partitioner.cpp:36-268,
    graph_path_association_finder.cpp:119-156).  ``steps`` holds each
    path's (node id << 1 | reverse) steps, ``offsets`` [n_paths + 1] their
    bounds, ``start_handles`` each snarl's start (node id << 1 |
    orientation) and ``pheno`` [n_paths] 1 for a case path.  Returns the
    snarls tested."""
    lib = get_baseline_lib()
    steps = np.ascontiguousarray(steps, np.uint64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    start_handles = np.ascontiguousarray(start_handles, np.uint64)
    pheno = np.ascontiguousarray(pheno, np.uint8)
    sink = ctypes.c_double()     # the p-value sum: the work is not elided
    return lib.stoat_baseline_graph(
        _ptr(steps, ctypes.c_uint64), _ptr(offsets, ctypes.c_int64),
        len(offsets) - 1, _ptr(start_handles, ctypes.c_uint64),
        len(start_handles), _ptr(pheno, ctypes.c_uint8),
        ctypes.byref(sink))


def run_baseline_cpp(matrix: np.ndarray, path_rows: np.ndarray,
                     path_row_offsets: np.ndarray,
                     snarl_offsets: np.ndarray, pheno_bin: np.ndarray,
                     pheno_q: np.ndarray, min_ind: int, min_hap: int,
                     maf: float) -> int:
    """The scalar per-snarl loop over a dense edge x haplotype ``matrix``
    (uint8) and the index arrays of :func:`pack_for_baseline`: the binary
    and the quantitative analysis of each snarl.  Returns the analyses
    that ran to a p-value (up to two a snarl)."""
    lib = get_baseline_lib()
    matrix = np.ascontiguousarray(matrix, np.uint8)
    path_rows = np.ascontiguousarray(path_rows, np.int32)
    path_row_offsets = np.ascontiguousarray(path_row_offsets, np.int64)
    snarl_offsets = np.ascontiguousarray(snarl_offsets, np.int64)
    pheno_bin = np.ascontiguousarray(pheno_bin, np.uint8)
    pheno_q = np.ascontiguousarray(pheno_q, np.float64)
    sink = ctypes.c_double()     # the p-value sum: the work is not elided
    return lib.stoat_baseline_run(
        _ptr(matrix, ctypes.c_uint8), matrix.shape[0], matrix.shape[1],
        _ptr(path_rows, ctypes.c_int32),
        _ptr(path_row_offsets, ctypes.c_int64),
        _ptr(snarl_offsets, ctypes.c_int64), len(snarl_offsets) - 1,
        _ptr(pheno_bin, ctypes.c_uint8), _ptr(pheno_q, ctypes.c_double),
        len(pheno_bin), min_ind, min_hap, maf, ctypes.byref(sink))


def pack_for_baseline(packed, edge_matrix, zero_row: int):
    """Each path's edge rows and each snarl's path offsets for
    :func:`run_baseline_cpp`: (path_rows int32, row_offsets int64 [P + 1],
    snarl_offsets int64 [S + 1]).

    A path with an edge missing from the matrix gets the all-zero row
    ``zero_row`` alone: the reference's identify_path aborts such a path
    (no carriers, snarl_analyzer.cpp:334-336)."""
    path_rows = []
    row_offsets = [0]
    snarl_offsets = [0]
    for snarl in packed.snarls:
        for path in snarl.paths:
            start = len(path_rows)
            for e in path_to_edges(path):
                if e[0][0] == 0 or e[1][0] == 0:
                    continue
                r = edge_matrix.find_edge(e)
                if r < 0:
                    del path_rows[start:]
                    path_rows.append(zero_row)   # no carriers
                    break
                path_rows.append(r)
            row_offsets.append(len(path_rows))
        snarl_offsets.append(snarl_offsets[-1] + len(snarl.paths))
    return (np.array(path_rows, np.int32),
            np.array(row_offsets, np.int64),
            np.array(snarl_offsets, np.int64))
