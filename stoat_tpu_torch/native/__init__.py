"""Native C++ cores of the port, bound with ctypes.

``stoat_core.cpp`` is the streaming VCF parser that builds each
chromosome's edge x haplotype words, the path resolver and the row
formatters; ``graph_core.cpp`` is graph mode's prepare (GFA load, snarl
finding, walk-set partitions, the tree walk, the row splice) and the snarl
decomposition.  Both compile with g++ at first use into
``build/stoat_tpu_torch/native/`` at the root of the checkout.  A
library's file name carries a key of its source bytes, the compiler flags
and the host CPU (model name and flags from /proc/cpuinfo): the flags
include -march=native, so a library built on another machine is never
loaded.  Concurrent first uses (test workers) build once, under a file
lock.  When no compiler is available the callers fall back to the Python
reader and formatters.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("stoat")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "stoat_core.cpp")
_GRAPH_SRC = os.path.join(_HERE, "graph_core.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "stoat_tpu_torch", "native")
# -march=native first; a toolchain that rejects it builds portable code
CXX_FLAGS = ("-O3", "-std=c++17", "-march=native", "-shared", "-fPIC",
             "-pthread")
_CORE_LIBS = ("-lz",)

_lib = None
_tried = False
_graph_lib = None
_graph_tried = False


def host_key() -> str:
    """The host CPU: the model names and flag sets of /proc/cpuinfo."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return os.uname().machine
    keep = {line.split(":", 1)[0].strip() + ":" + line.split(":", 1)[1]
            for line in lines if ":" in line
            and line.split(":", 1)[0].strip() in ("model name", "flags")}
    return "\n".join(sorted(keep))


def library_path(src: str, libs: Tuple[str, ...] = ()) -> str:
    """Where the library of ``src`` lives: its name carries a key of the
    source bytes, the flags and :func:`host_key`."""
    with open(src, "rb") as fh:
        key = hashlib.sha256(fh.read())
    key.update(" ".join((*CXX_FLAGS, *libs)).encode())
    key.update(host_key().encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{key.hexdigest()[:16]}.so")


def _compile(src: str, lib: str, extra=()) -> bool:
    tmp = f"{lib}.{os.getpid()}.tmp"
    for flags in (CXX_FLAGS, tuple(f for f in CXX_FLAGS
                                   if f != "-march=native")):
        cmd = ["g++", *flags, src, *extra, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            logger.warning("native build failed to launch: %s", e)
            return False
        if res.returncode == 0:
            os.replace(tmp, lib)
            return True
    logger.warning("native build failed:\n%s",
                   res.stderr.decode(errors="replace"))
    return False


def _built(src: str, libs: Tuple[str, ...]) -> Optional[str]:
    """The path of ``src``'s library, built first when it is not there
    (one build at a time per library), or None when the build fails."""
    lib = library_path(src, libs)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib) or _compile(src, lib, libs):
            return lib
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native core, or None."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    path = _built(_SRC, _CORE_LIBS)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        logger.warning("native core load failed: %s", e)
        return None
    lib.stoat_vcf_open.restype = ctypes.c_void_p
    lib.stoat_vcf_open.argtypes = [ctypes.c_char_p]
    lib.stoat_vcf_read_error.restype = ctypes.c_int
    lib.stoat_vcf_read_error.argtypes = [ctypes.c_void_p]
    lib.stoat_vcf_n_samples.restype = ctypes.c_int64
    lib.stoat_vcf_n_samples.argtypes = [ctypes.c_void_p]
    lib.stoat_vcf_sample.restype = ctypes.c_char_p
    lib.stoat_vcf_sample.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.stoat_vcf_next_chunk.restype = ctypes.c_void_p
    lib.stoat_vcf_next_chunk.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.stoat_chunk_chrom.restype = ctypes.c_char_p
    lib.stoat_chunk_chrom.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_rows.restype = ctypes.c_uint64
    lib.stoat_chunk_rows.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_cols.restype = ctypes.c_uint64
    lib.stoat_chunk_cols.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_nwords.restype = ctypes.c_uint64
    lib.stoat_chunk_nwords.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_n_records.restype = ctypes.c_uint64
    lib.stoat_chunk_n_records.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_n_with_at.restype = ctypes.c_uint64
    lib.stoat_chunk_n_with_at.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_words.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.stoat_chunk_words.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_matrix.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.stoat_chunk_matrix.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_edges.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.stoat_chunk_edges.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_free.argtypes = [ctypes.c_void_p]
    lib.stoat_vcf_close.argtypes = [ctypes.c_void_p]
    lib.stoat_chunk_resolve_idx.restype = ctypes.c_int64
    lib.stoat_chunk_resolve_idx.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.stoat_resolve_paths.restype = ctypes.c_int64
    lib.stoat_resolve_paths.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.stoat_free_buf.argtypes = [ctypes.c_void_p]
    lib.stoat_format_binary_rows.restype = ctypes.c_void_p
    lib.stoat_format_binary_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.stoat_format_quant_rows.restype = ctypes.c_void_p
    lib.stoat_format_quant_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64)]
    _lib = lib
    return _lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def format_binary_rows(chrom: str, prefixes: bytes, depths, filtered,
                       p_fisher, p_chi2, g0, g1, keep, S: int):
    """C++ batch formatter for binary result rows; returns bytes or None.

    Exact twin of the per-row Python path (writer.write_binary_row +
    format_p + format_group_paths), pinned by tests."""
    lib = get_lib()
    if lib is None:
        return None
    depths = np.ascontiguousarray(depths, np.int64)
    filtered = np.ascontiguousarray(filtered, np.uint8)
    p_fisher = np.ascontiguousarray(p_fisher, np.float64)
    p_chi2 = np.ascontiguousarray(p_chi2, np.float64)
    g0 = np.ascontiguousarray(g0, np.float64)
    g1 = np.ascontiguousarray(g1, np.float64)
    keep = np.ascontiguousarray(keep, np.uint8)
    out_len = ctypes.c_uint64()
    ptr = lib.stoat_format_binary_rows(
        chrom.encode(), prefixes,
        depths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        filtered.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _dptr(p_fisher), _dptr(p_chi2), _dptr(g0), _dptr(g1),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        S, g0.shape[1], ctypes.byref(out_len))
    if not ptr:
        return None
    blob = ctypes.string_at(ptr, out_len.value)
    lib.stoat_free_buf(ptr)
    return blob


def format_quant_rows(chrom: str, prefixes: bytes, depths, filtered,
                      p, r2, beta, se, allele_paths, n_paths, S: int,
                      has_r2: bool):
    """C++ batch formatter for quantitative/covar result rows."""
    lib = get_lib()
    if lib is None:
        return None
    depths = np.ascontiguousarray(depths, np.int64)
    filtered = np.ascontiguousarray(filtered, np.uint8)
    p = np.ascontiguousarray(p, np.float64)
    r2 = np.ascontiguousarray(r2 if r2 is not None else p, np.float64)
    beta = np.ascontiguousarray(beta, np.float64)
    se = np.ascontiguousarray(se, np.float64)
    allele_paths = np.ascontiguousarray(allele_paths, np.int32)
    n_paths = np.ascontiguousarray(n_paths, np.int64)
    out_len = ctypes.c_uint64()
    ptr = lib.stoat_format_quant_rows(
        chrom.encode(), prefixes,
        depths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        filtered.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _dptr(p), _dptr(r2), _dptr(beta), _dptr(se),
        allele_paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        S, allele_paths.shape[1], 1 if has_r2 else 0,
        ctypes.byref(out_len))
    if not ptr:
        return None
    blob = ctypes.string_at(ptr, out_len.value)
    lib.stoat_free_buf(ptr)
    return blob


def resolve_paths_native(edges: np.ndarray, blob: str):
    """Resolve a chromosome's path-string blob to edge rows in C++.

    ``edges`` is the [E, 4] uint64 (a_id, a_rev, b_id, b_rev) row table;
    ``blob`` the comma-joined path strings.  Returns (rows uint32 [nnz],
    offsets uint64 [P+1], valid uint8 [P]) or None when the native core
    is unavailable (callers fall back to the numpy tokenizer).
    Semantics match identify_path: node-0 edges skipped, unknown edges
    invalidate the path (snarl_analyzer.cpp:326-336)."""
    lib = get_lib()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, np.uint64).reshape(-1, 4)
    try:
        data = blob.encode("ascii")
    except UnicodeEncodeError:
        return None
    rows_p = ctypes.POINTER(ctypes.c_uint32)()
    offs_p = ctypes.POINTER(ctypes.c_uint64)()
    valid_p = ctypes.POINTER(ctypes.c_uint8)()
    P = lib.stoat_resolve_paths(
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        edges.shape[0], data, len(data),
        ctypes.byref(rows_p), ctypes.byref(offs_p), ctypes.byref(valid_p))
    if P < 0:
        return None
    offs = np.ctypeslib.as_array(offs_p, shape=(P + 1,)).astype(np.int64)
    nnz = int(offs[-1])
    rows = (np.ctypeslib.as_array(rows_p, shape=(max(nnz, 1),))
            [:nnz].copy())
    valid = np.ctypeslib.as_array(valid_p, shape=(max(P, 1),))[:P].copy()
    lib.stoat_free_buf(rows_p)
    lib.stoat_free_buf(offs_p)
    lib.stoat_free_buf(valid_p)
    return rows, offs, valid


def get_graph_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native decomposition core, or None."""
    global _graph_lib, _graph_tried
    if _graph_lib is not None:
        return _graph_lib
    if _graph_tried:
        return None
    _graph_tried = True
    path = _built(_GRAPH_SRC, ())
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        logger.warning("native graph core load failed: %s", e)
        return None
    lib.stoat_decompose_gfa.restype = ctypes.c_int
    lib.stoat_decompose_gfa.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p)]
    lib.stoat_decompose_arrays.restype = ctypes.c_int
    lib.stoat_decompose_arrays.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p)]
    lib.stoat_free_str.argtypes = [ctypes.c_void_p]
    lib.stoat_graph_partitions.restype = ctypes.c_long
    lib.stoat_graph_partitions.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))]
    lib.stoat_graph_format_rows.restype = ctypes.c_void_p
    lib.stoat_graph_format_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64)]
    _assoc_outs = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(ctypes.c_long)]
    lib.stoat_graph_assoc.restype = ctypes.c_long
    lib.stoat_graph_assoc.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_long, ctypes.c_long] + _assoc_outs
    lib.stoat_graph_assoc_mem.restype = ctypes.c_long
    lib.stoat_graph_assoc_mem.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_long, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_long, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_long, ctypes.c_long] + _assoc_outs
    _graph_lib = lib
    return _graph_lib


def _assoc_out_ptrs():
    return (ctypes.POINTER(ctypes.c_char)(), ctypes.c_uint64(),
            ctypes.POINTER(ctypes.c_uint8)(),
            ctypes.POINTER(ctypes.c_uint64)(),
            ctypes.POINTER(ctypes.c_uint32)(),
            ctypes.POINTER(ctypes.c_uint32)(), ctypes.c_long())


def _decode_assoc_result(lib, n_rows, rows_p, rows_len, kind_p, offs_p,
                         g0_p, g1_p, n_snarls, src: str):
    if n_rows == -1:
        raise RuntimeError(f"could not read GFA: {src}")
    if n_rows == -2:
        raise RuntimeError("No graph paths match the phenotype samples")
    if n_rows < 0:
        return None
    n = int(n_rows)
    blob = ctypes.string_at(rows_p, rows_len.value)
    kinds = np.ctypeslib.as_array(kind_p, shape=(max(n, 1),))[:n].copy()
    offs = np.ctypeslib.as_array(offs_p, shape=(n + 1,)).astype(np.int64)
    total = int(offs[-1])
    g0 = np.ctypeslib.as_array(g0_p, shape=(max(total, 1),))[:total].copy()
    g1 = np.ctypeslib.as_array(g1_p, shape=(max(total, 1),))[:total].copy()
    for p in (rows_p, kind_p, offs_p, g0_p, g1_p):
        lib.stoat_free_str(p)
    return blob, kinds, offs, g0, g1, int(n_snarls.value)


def graph_assoc_native(gfa_path: str, ref_names, pheno_samples,
                       pheno_case: np.ndarray, test_method: str,
                       allele_size_limit: int, threads: int = 0,
                       output_format: str = "tsv"):
    """One-call native `stoat graph` prepare: GFA load + snarl finding +
    walk-set partitioning + tree walk (graph_core.cpp stoat_graph_assoc;
    reference pipeline graph.cpp:217-288 + partitioner.cpp:36-268 +
    graph_path_association_finder.cpp:29-199).

    Returns (blob, kinds, part_offs, g0, g1, n_snarls) where ``blob`` is
    the '\\0'-joined row payloads in walk order — kind 0 entries are
    complete lines, kind 1 entries "prefix\\x01suffix" awaiting the
    device p-values (splice with graph_format_rows_native) — or None
    when the native core is unavailable.  With ``output_format="fasta"``
    the blob is instead the COMPLETE FASTA text (writer.cpp:89-178) and
    kinds/part_offs/g0/g1 are empty.  Raises RuntimeError for real
    input errors (unreadable GFA / no matching phenotype paths)."""
    lib = get_graph_lib()
    if lib is None:
        return None
    refs = ",".join(sorted(ref_names)) if ref_names else ""
    names_blob = ("\0".join(pheno_samples) + "\0").encode()
    case = np.ascontiguousarray(pheno_case, np.uint8)
    outs = _assoc_out_ptrs()
    n_rows = lib.stoat_graph_assoc(
        gfa_path.encode(), refs.encode(), names_blob, len(pheno_samples),
        case.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if test_method == "exact" else 0,
        1 if output_format == "fasta" else 0, allele_size_limit, threads,
        *[ctypes.byref(o) for o in outs])
    return _decode_assoc_result(lib, n_rows, *outs, gfa_path)


def graph_assoc_mem_native(g, ref_names, pheno_samples,
                           pheno_case: np.ndarray, test_method: str,
                           allele_size_limit: int, threads: int = 0,
                           output_format: str = "tsv"):
    """graph_assoc_native fed from an in-memory GfaGraph-shaped object —
    the production path for the reference's binary graph containers
    (.hg/.pg/.gbz, graph.cpp:217-224): the Python format reader decodes
    the container, the graph is handed over once as flat arrays, and the
    whole prepare (snarl finding + partitioning + walk) runs native
    (graph_core.cpp stoat_graph_assoc_mem)."""
    lib = get_graph_lib()
    if lib is None:
        return None
    node_ids = np.fromiter(g.sequences.keys(), np.uint64,
                           count=len(g.sequences))
    node_ids.sort()
    want_seq = output_format == "fasta"
    seqs = [g.sequences[int(n)] for n in node_ids]
    node_lens = np.fromiter((len(s) for s in seqs), np.uint32,
                            count=len(seqs))
    if want_seq:
        seq_blob = "".join(seqs).encode()
        seq_offs = np.zeros(len(seqs) + 1, np.uint64)
        np.cumsum(node_lens, out=seq_offs[1:])
    edge_list = []
    for u, vs in g._succ.items():
        uh = (u[0] << 1) | int(u[1])
        for v in vs:
            edge_list.append((uh, (v[0] << 1) | int(v[1])))
    edges = np.array(edge_list, np.uint64).reshape(-1, 2) \
        if edge_list else np.zeros((0, 2), np.uint64)
    steps_flat: list = []
    step_offs = [0]
    names = []
    samples = []
    is_ref = []
    for p in g.paths:
        steps_flat.extend((st[0] << 1) | int(st[1]) for st in p.steps)
        step_offs.append(len(steps_flat))
        names.append(p.name)
        samples.append(p.sample)
        is_ref.append(1 if p.is_reference else 0)
    steps_arr = np.array(steps_flat, np.uint64)
    offs_arr = np.array(step_offs, np.int64)
    ref_flags = np.array(is_ref, np.uint8)
    refs = ",".join(sorted(ref_names)) if ref_names else ""
    pnames_blob = ("\0".join(names) + "\0").encode() if names else b"\0"
    psamp_blob = ("\0".join(samples) + "\0").encode() if samples else b"\0"
    names_blob = ("\0".join(pheno_samples) + "\0").encode()
    case = np.ascontiguousarray(pheno_case, np.uint8)
    outs = _assoc_out_ptrs()

    def u64p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    n_rows = lib.stoat_graph_assoc_mem(
        u64p(node_ids),
        node_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(node_ids),
        seq_blob if want_seq else None,
        u64p(seq_offs) if want_seq else None,
        u64p(np.ascontiguousarray(edges)), len(edges),
        u64p(steps_arr),
        offs_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(names), pnames_blob, psamp_blob,
        ref_flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        refs.encode(), names_blob, len(pheno_samples),
        case.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if test_method == "exact" else 0,
        1 if output_format == "fasta" else 0, allele_size_limit, threads,
        *[ctypes.byref(o) for o in outs])
    return _decode_assoc_result(lib, n_rows, *outs, "<memory graph>")


def graph_format_rows_native(blob: bytes, kinds: np.ndarray,
                             p22, pf, pn, is_two) -> Optional[bytes]:
    """Splice device p-values into stoat_graph_assoc row payloads and
    return the final TSV text (C++ set_precision twin), or None."""
    lib = get_graph_lib()
    if lib is None:
        return None
    kinds = np.ascontiguousarray(kinds, np.uint8)
    p22 = np.ascontiguousarray(p22, np.float64)
    pf = np.ascontiguousarray(pf, np.float64)
    pn = np.ascontiguousarray(pn, np.float64)
    is_two = np.ascontiguousarray(is_two, np.uint8)
    out_len = ctypes.c_uint64()
    ptr = lib.stoat_graph_format_rows(
        blob, len(blob),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(kinds), _dptr(p22), _dptr(pf), _dptr(pn),
        is_two.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(out_len))
    if not ptr:
        return None
    out = ctypes.string_at(ptr, out_len.value)
    lib.stoat_free_str(ptr)
    return out


def graph_partitions_native(steps: np.ndarray, offsets: np.ndarray,
                            path_sample: np.ndarray, n_samples: int,
                            start_handles: np.ndarray,
                            sample_case: np.ndarray,
                            threads: int = 0):
    """Per-snarl walk-set partition counts via the native core.

    The production graph-mode hot loop (partitioner.cpp:36-268 per-snarl
    refinement) parallel over snarls.  Returns (part_offs int64
    [n_snarls+1], n_case uint32, n_ctrl uint32, rep int32) or None when
    the native core is unavailable."""
    lib = get_graph_lib()
    if lib is None:
        return None
    steps = np.ascontiguousarray(steps, np.uint64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    path_sample = np.ascontiguousarray(path_sample, np.int32)
    start_handles = np.ascontiguousarray(start_handles, np.uint64)
    sample_case = np.ascontiguousarray(sample_case, np.uint8)
    po = ctypes.POINTER(ctypes.c_uint64)()
    pc = ctypes.POINTER(ctypes.c_uint32)()
    pt = ctypes.POINTER(ctypes.c_uint32)()
    pr = ctypes.POINTER(ctypes.c_int32)()
    total = lib.stoat_graph_partitions(
        steps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offsets) - 1,
        path_sample.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_samples,
        start_handles.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(start_handles),
        sample_case.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads,
        ctypes.byref(po), ctypes.byref(pc), ctypes.byref(pt),
        ctypes.byref(pr))
    if total < 0:
        return None
    S = len(start_handles)
    offs = np.ctypeslib.as_array(po, shape=(S + 1,)).astype(np.int64)
    n_case = np.ctypeslib.as_array(pc, shape=(max(total, 1),))[:total].copy()
    n_ctrl = np.ctypeslib.as_array(pt, shape=(max(total, 1),))[:total].copy()
    rep = np.ctypeslib.as_array(pr, shape=(max(total, 1),))[:total].copy()
    for p in (po, pc, pt, pr):
        lib.stoat_free_str(p)          # plain free() in graph_core
    return offs, n_case, n_ctrl, rep


def native_decompose_graph(g, children_threshold: int = 50,
                           path_length_threshold: int = 10000,
                           cycle_threshold: int = 1) -> Tuple[str, str]:
    """Run the C++ decomposition on an already-loaded graph object.

    Feeds the natively-loaded binary formats (.hg/.pg/.gbz readers)
    straight into graph_core as flat arrays — no temporary GFA round
    trip.  The successor lists pass through verbatim, so enumeration
    order (and thus the TSV) matches the Python decomposition of the
    same graph.  Raises RuntimeError when unavailable/failed (callers
    fall back to the Python implementation).
    """
    lib = get_graph_lib()
    if lib is None:
        raise RuntimeError("native graph core unavailable")

    node_ids = np.fromiter(g.sequences.keys(), np.uint64,
                           len(g.sequences))
    order = np.argsort(node_ids, kind="stable")
    node_ids = node_ids[order]
    node_lens = np.fromiter((len(g.sequences[int(n)]) for n in node_ids),
                            np.uint32, len(node_ids))

    pairs: list = []
    for u, vs in g._succ.items():
        ku = (u[0] << 1) | int(u[1])
        for v in vs:
            pairs.append(ku)
            pairs.append((v[0] << 1) | int(v[1]))
    succ = np.array(pairs, np.uint64).reshape(-1, 2)

    steps: list = []
    offsets = [0]
    names = []
    samples = []
    is_ref = np.zeros(len(g.paths), np.uint8)
    for i, p in enumerate(g.paths):
        steps.extend((st[0] << 1) | int(st[1]) for st in p.steps)
        offsets.append(len(steps))
        names.append(p.name)
        samples.append(p.sample)
        is_ref[i] = 1 if p.is_reference else 0
    steps_arr = np.array(steps, np.uint64)
    offsets_arr = np.array(offsets, np.uint64)
    names_blob = ("\0".join(names) + "\0").encode()
    samples_blob = ("\0".join(samples) + "\0").encode()

    tsv = ctypes.c_char_p()
    rejects = ctypes.c_char_p()
    error = ctypes.c_char_p()

    def u64p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    rc = lib.stoat_decompose_arrays(
        u64p(node_ids),
        node_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(node_ids), u64p(succ), succ.shape[0],
        u64p(steps_arr), u64p(offsets_arr), len(g.paths),
        names_blob, samples_blob,
        is_ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        children_threshold, path_length_threshold, cycle_threshold,
        ctypes.byref(tsv), ctypes.byref(rejects), ctypes.byref(error))
    if rc != 0:
        message = (error.value or b"unknown error").decode()
        if error:
            lib.stoat_free_str(error)
        raise RuntimeError(f"native decomposition failed: {message}")
    tsv_str = tsv.value.decode()
    rejects_str = rejects.value.decode()
    lib.stoat_free_str(tsv)
    lib.stoat_free_str(rejects)
    return tsv_str, rejects_str


def native_decompose_gfa(gfa_path: str, ref_names,
                         children_threshold: int = 50,
                         path_length_threshold: int = 10000,
                         cycle_threshold: int = 1) -> Tuple[str, str]:
    """Run the C++ snarl decomposition; returns (snarl TSV, rejects TSV).

    Raises RuntimeError when the native core is unavailable or the
    decomposition fails (callers fall back to the Python implementation).
    """
    lib = get_graph_lib()
    if lib is None:
        raise RuntimeError("native graph core unavailable")
    tsv = ctypes.c_char_p()
    rejects = ctypes.c_char_p()
    error = ctypes.c_char_p()
    refs = ",".join(sorted(ref_names)) if ref_names else ""
    rc = lib.stoat_decompose_gfa(
        gfa_path.encode(), refs.encode(), children_threshold,
        path_length_threshold, cycle_threshold,
        ctypes.byref(tsv), ctypes.byref(rejects), ctypes.byref(error))
    if rc != 0:
        message = (error.value or b"unknown error").decode()
        if error:
            lib.stoat_free_str(error)
        raise RuntimeError(f"native decomposition failed: {message}")
    tsv_str = tsv.value.decode()
    rejects_str = rejects.value.decode()
    lib.stoat_free_str(tsv)
    lib.stoat_free_str(rejects)
    return tsv_str, rejects_str


class _ChunkOwner:
    """Keeps a native Chunk alive while numpy views reference its memory."""

    def __init__(self, lib, cp):
        self._lib = lib
        self._cp = cp

    def __del__(self):
        if self._cp:
            self._lib.stoat_chunk_free(self._cp)
            self._cp = None


def _owned_view(ptr, shape, dtype, owner):
    """Zero-copy ndarray over native memory, lifetime tied to ``owner``.

    The owner must hang off the ROOT buffer object: numpy collapses view
    chains to the root base, so an attribute on an intermediate ndarray
    (or subclass) is silently dropped by the first ``asarray``/slice —
    measured as a chunk freed while device uploads still read it.  ctypes
    array instances accept attributes and stay the root base of every
    derived view."""
    n = int(np.prod(shape))
    buf = (ptr._type_ * n).from_address(
        ctypes.addressof(ptr.contents))
    buf._owner = owner
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
    # the views alias shared native buffers (siblings see the same bytes);
    # keep the old copy semantics' safety by refusing in-place mutation
    arr.flags.writeable = False
    return arr


def _make_chunk_resolver(lib, owner):
    """Closure resolving a path blob against a live chunk's edge table.

    Returns ``(idx, rows, offs, valid)`` — the fused C++ resolution
    (stoat_chunk_resolve_idx): ``idx`` is the pack-ready padded
    [P, K] int32 index matrix (padding = n_rows, the AND-identity row;
    the exact pack_path_edge_idx contract), the rest mirror
    resolve_paths_native.  Returns None on failure (callers fall back)."""

    def resolve(blob: str):
        if not getattr(owner, "_cp", None):
            return None
        try:
            data = blob.encode("ascii")
        except UnicodeEncodeError:
            return None
        k = ctypes.c_int64()
        idx_p = ctypes.POINTER(ctypes.c_int32)()
        rows_p = ctypes.POINTER(ctypes.c_uint32)()
        offs_p = ctypes.POINTER(ctypes.c_uint64)()
        valid_p = ctypes.POINTER(ctypes.c_uint8)()
        P = lib.stoat_chunk_resolve_idx(
            owner._cp, data, len(data), ctypes.byref(k),
            ctypes.byref(idx_p), ctypes.byref(rows_p),
            ctypes.byref(offs_p), ctypes.byref(valid_p))
        if P < 0:
            return None
        K = int(k.value)
        idx = np.ctypeslib.as_array(
            idx_p, shape=(max(P, 1), K))[:P].copy()
        offs = np.ctypeslib.as_array(
            offs_p, shape=(P + 1,)).astype(np.int64)
        nnz = int(offs[-1])
        rows = (np.ctypeslib.as_array(rows_p, shape=(max(nnz, 1),))
                [:nnz].copy())
        valid = np.ctypeslib.as_array(
            valid_p, shape=(max(P, 1),))[:P].copy()
        lib.stoat_free_buf(idx_p)
        lib.stoat_free_buf(rows_p)
        lib.stoat_free_buf(offs_p)
        lib.stoat_free_buf(valid_p)
        return idx, rows, offs, valid

    return resolve


class NativeVcfMatrixReader:
    """Streams per-chromosome edge×haplotype matrices via the C++ core."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native core unavailable")
        self._lib = lib
        self._handle = lib.stoat_vcf_open(path.encode())
        if not self._handle:
            raise RuntimeError(f"native core could not open {path}")
        n = lib.stoat_vcf_n_samples(self._handle)
        self.samples = [lib.stoat_vcf_sample(self._handle, i).decode()
                        for i in range(n)]

    def chunks_packed(self, initial_rows: int = 1024):
        """Yield (chrom, words uint32 [E+1, W], n_haplotypes,
        edges uint64 [E, 4]).

        The words are the bit-packed edge×haplotype matrix in exactly the
        device kernels' layout (32 haplotypes/word, little bit order,
        trailing all-ones AND-identity row — pipeline/packed.py),
        straight from the C++ fill with no host repack.  The edges array
        is (a_id, a_rev, b_id, b_rev) per row; no Python dict is built
        (see PackedEdgeMatrix.resolve_edges)."""
        lib = self._lib
        while True:
            cp = lib.stoat_vcf_next_chunk(self._handle, initial_rows)
            if not cp:
                if lib.stoat_vcf_read_error(self._handle):
                    raise RuntimeError(
                        "VCF stream read error mid-file (truncated or "
                        "corrupt gzip?) — results would be silently "
                        "partial")
                return
            rows = int(lib.stoat_chunk_rows(cp))
            cols = int(lib.stoat_chunk_cols(cp))
            nwords = int(lib.stoat_chunk_nwords(cp))
            chrom = lib.stoat_chunk_chrom(cp).decode()
            self.last_counts = (int(lib.stoat_chunk_n_records(cp)),
                                int(lib.stoat_chunk_n_with_at(cp)))
            if rows == 0:
                # e.g. a chromosome whose records all lack AT fields
                words = np.full((1, nwords), 0xFFFFFFFF, np.uint32)
                edges = np.zeros((0, 4), np.uint64)
                self.last_resolver = None
                lib.stoat_chunk_free(cp)
            else:
                # zero-copy: the arrays view the Chunk's buffers; the
                # owner frees the Chunk when the last view is collected
                owner = _ChunkOwner(lib, cp)
                words = _owned_view(lib.stoat_chunk_words(cp),
                                    (rows + 1, nwords), np.uint32, owner)
                edges = _owned_view(lib.stoat_chunk_edges(cp),
                                    (rows, 4), np.uint64, owner)
                # fused path resolution against this chunk's own edge
                # table (the resolver keeps the chunk alive)
                self.last_resolver = _make_chunk_resolver(lib, owner)
            yield chrom, words, cols, edges

    def close(self) -> None:
        if self._handle:
            self._lib.stoat_vcf_close(self._handle)
            self._handle = None
