"""Sharded analysis over the snarl mesh: one shard a device.

The port of stoat_tpu/parallel/sharded.py.  The JAX package ran one
``shard_map`` program over the mesh; here a host loop runs each shard
through the port's single-device code on the shard's own device: hand
kernels on CUDA tensors, their plain versions on CPU tensors.  The
replicated inputs (the bit-packed words, the tail and phenotype masks,
the covariates, the rotation, the permutation rows) are uploaded once to
each distinct device of the mesh (:class:`Replicated`): a mesh that names
one card four times holds one copy.  Each shard's path tables go to its
device as a ``convert.DeviceChunk``.  Every shard's launches are issued
before anything is fetched, so that distinct cards overlap; then each
shard's host copies start (``fetch.fetch_async``), and the results are
gathered into global snarl order, each shard's padding dropped
(:class:`ShardedResult`, stoat_tpu's ``_unshard`` and ``_unshard_perm``).

Results are per snarl (eQTL: per pair), so their bits do not depend on
the split.  The chi-squared and Student-t tails (K5, K10) run inside each
shard, on its device: the JAX package finished them on gathered arrays
only to keep XLA's partitioner from unrolling their loops.  A shard whose
launch fails raises; nothing moves to another device or to a plain
version.

A function given ``replicated`` keeps its uploads there for the next
call with the same host objects (the runner's chromosome words and run
phenotype); without it, each call uploads afresh.
"""

from __future__ import annotations

import threading
from collections.abc import Mapping
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stoat_tpu_torch.convert import DeviceChunk, upload
from stoat_tpu_torch.parallel.mesh import ShardedChromosome, SnarlMesh
from stoat_tpu_torch.pipeline.binary import binary_tables_packed
from stoat_tpu_torch.pipeline.fetch import (DeviceTables, HostResult,
                                            fetch_async)
from stoat_tpu_torch.pipeline.packed import (pack_hap_mask_words,
                                             tail_mask_words)
from stoat_tpu_torch.pipeline.permutation import (binary_perm_pvalues,
                                                  perm_binary_stats,
                                                  perm_membership,
                                                  perm_ols_stats,
                                                  quant_perm_pvalues,
                                                  score_perm_pvalues,
                                                  score_perm_stats,
                                                  score_precompute)
from stoat_tpu_torch.pipeline.quantitative import (
    binary_covar_analyze_chunk, dual_chunk_tables, eqtl_ols_stats,
    lmm_analyze_chunk, pair_snarls, quant_design, quantitative_analyze_chunk)
from stoat_tpu_torch.stats.linreg import student_t_pvalues

__all__ = ["binary_analyze_sharded", "quantitative_analyze_sharded",
           "lmm_analyze_sharded", "binary_covar_analyze_sharded",
           "eqtl_regress_pairs_sharded", "dual_analyze_sharded",
           "binary_perm_pvalues_sharded", "quant_perm_pvalues_sharded",
           "logistic_score_perm_sharded", "ShardedPermState", "Replicated",
           "ShardedResult"]

Thresholds = Tuple[float, float, float]


class Replicated:
    """Host inputs replicated on a mesh: each uploaded once to every
    distinct device of the mesh, and kept under its name while the caller
    hands in the same host object (``source``); another object replaces
    the copies (the next chromosome's words).  ``uploads`` counts the
    copies made under each name."""

    def __init__(self, mesh: SnarlMesh):
        self.mesh = mesh
        self._held: Dict[str, Tuple[object, List[torch.Tensor]]] = {}
        self.uploads: Dict[str, int] = {}

    def get(self, name: str, source,
            make: Callable[[object], np.ndarray]) -> List[torch.Tensor]:
        """One tensor per shard of ``make(source)``, uploaded once to each
        distinct device (shards on one device share it)."""
        held = self._held.pop(name, None)
        if held is not None and held[0] is source:
            self._held[name] = held
            return held[1]
        # the old copies go before the new ones are made (the device then
        # holds one chromosome's words at a time)
        del held
        arr = make(source)
        on = {}
        for dev in self.mesh.distinct:
            on[dev] = upload(arr, dev)
            self.uploads[name] = self.uploads.get(name, 0) + 1
        tensors = [on[dev] for dev in self.mesh.devices]
        self._held[name] = (source, tensors)
        return tensors


def _f64(a) -> np.ndarray:
    return np.asarray(a, np.float64)


def _words_i32(words) -> np.ndarray:
    return np.ascontiguousarray(words, np.uint32).view(np.int32)


class ShardedTables:
    """The -T table view of a sharded chunk: each shard's
    ``fetch.DeviceTables`` stays on its device, and :meth:`rows` gathers
    the asked-for snarls (global indices) from their shards."""

    def __init__(self, parts: Sequence[DeviceTables], sizes: Sequence[int]):
        self._parts = list(parts)
        self._starts = np.cumsum([0, *sizes])

    def rows(self, snarls: Sequence[int]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(norm, used, kept) of ``snarls`` on the host, in that order."""
        snarls = np.asarray(list(snarls), np.int64)
        shard = np.searchsorted(self._starts, snarls, side="right") - 1
        got = [None] * len(snarls)
        for d in np.unique(shard):
            where = np.flatnonzero(shard == d)
            parts = self._parts[d].rows(snarls[where] - self._starts[d])
            for j, i in enumerate(where):
                got[i] = tuple(a[j] for a in parts)
        return tuple(np.stack([g[k] for g in got]) for k in range(3))


class ShardedResult(Mapping):
    """A sharded call's outputs in global order: each shard's
    ``fetch.HostResult`` (its copies in flight) trimmed to its real
    length along ``axis`` (0: snarls or pairs lead, 1: the permutation
    pass's [K, S]) and concatenated.  The first key read waits for every
    shard; ``tables`` is the -T view (:class:`ShardedTables`) or None."""

    def __init__(self, parts: Sequence[HostResult], sizes: Sequence[int],
                 axis: int = 0, tables: Optional[ShardedTables] = None):
        self._parts = list(parts)
        self._sizes = list(sizes)
        self._axis = axis
        self._keys = list(self._parts[0])
        self._out: Optional[Dict[str, np.ndarray]] = None
        self._lock = threading.Lock()
        self.tables = tables

    def _gather(self) -> Dict[str, np.ndarray]:
        with self._lock:
            if self._out is None:
                cut = (slice(None),) * self._axis
                self._out = {
                    key: np.concatenate(
                        [part[key][cut + (slice(0, n),)]
                         for part, n in zip(self._parts, self._sizes)],
                        axis=self._axis)
                    for key in self._keys}
                self._parts = []
            return self._out

    def __getitem__(self, key: str) -> np.ndarray:
        return self._gather()[key]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def _shard_chunks(sharded: ShardedChromosome, mesh: SnarlMesh,
                  rep: Replicated,
                  binary_phenotype: Optional[np.ndarray] = None
                  ) -> List[DeviceChunk]:
    """Each shard's ``DeviceChunk`` on its device: the replicated words
    (and, given a binary phenotype, its tail and case masks), and the
    shard's own path tables."""
    if len(mesh) != sharded.n_shards:
        raise ValueError(f"{sharded.n_shards} shards on a mesh of "
                         f"{len(mesh)} devices")
    words = rep.get("words", sharded.words, _words_i32)
    W = int(sharded.words.shape[1])
    masks = [(None, None)] * len(mesh)
    if binary_phenotype is not None:
        g1 = rep.get("case mask", binary_phenotype, lambda ph:
                     pack_hap_mask_words(np.repeat(
                         np.asarray(ph).astype(bool), 2), W).view(np.int32))
        tail = rep.get("tail", sharded.words, lambda w: tail_mask_words(
            sharded.n_haps, W).view(np.int32))
        masks = list(zip(g1, tail))
    return [DeviceChunk(words=words[d],
                        path_idx=upload(sharded.path_idx[d], dev),
                        path_valid=upload(sharded.path_valid[d], dev),
                        snarl_path_idx=upload(sharded.snarl_path_idx[d], dev),
                        g1_words=masks[d][0], tail=masks[d][1])
            for d, dev in enumerate(mesh.devices)]


def _covariates(rep: Replicated, covar, n_samples: int
                ) -> List[torch.Tensor]:
    """The [N, C] covariates on every shard's device ([N, 0] for none)."""
    return rep.get("covariates", covar, lambda c: np.zeros(
        (n_samples, 0)) if c is None else _f64(c))


def _results(parts: Sequence[HostResult], sharded: ShardedChromosome,
             tables: bool = False) -> ShardedResult:
    view = (ShardedTables([p.tables for p in parts], sharded.shard_sizes)
            if tables else None)
    return ShardedResult(parts, sharded.shard_sizes, tables=view)


def binary_analyze_sharded(sharded: ShardedChromosome,
                           binary_phenotype: np.ndarray, mesh: SnarlMesh,
                           min_individuals: int, min_haplotypes: int,
                           maf_threshold: float,
                           replicated: Optional[Replicated] = None
                           ) -> ShardedResult:
    """``vcf -b`` with the snarls sharded over ``mesh``: per shard the
    count, table and Fisher launch (K1+K2, K3, K4) and the chi-squared
    tail (K5), as ``pipeline/binary.py binary_tables_packed``.  Returns
    filtered, keep, g0, g1, p_fisher and p_chi2 in snarl order."""
    rep = replicated or Replicated(mesh)
    th = (min_individuals, min_haplotypes, maf_threshold)
    parts = [fetch_async(binary_tables_packed(chunk, *th))
             for chunk in _shard_chunks(sharded, mesh, rep, binary_phenotype)]
    return _results(parts, sharded)


def dual_analyze_sharded(sharded: ShardedChromosome,
                         binary_phenotype: np.ndarray,
                         quantitative_phenotype: np.ndarray,
                         mesh: SnarlMesh, min_individuals: int,
                         min_haplotypes: int, maf_threshold: float,
                         covariate=None,
                         replicated: Optional[Replicated] = None
                         ) -> ShardedResult:
    """The dual ``vcf -b -q`` with the snarls sharded over ``mesh``: per
    shard one membership pass feeding the binary tables and the
    quantitative OLS (``pipeline/quantitative.py dual_chunk_tables``).
    The quantitative keys carry the ``q_`` prefix."""
    rep = replicated or Replicated(mesh)
    th = (min_individuals, min_haplotypes, maf_threshold)
    qpheno = rep.get("quantitative phenotype", quantitative_phenotype, _f64)
    covar = _covariates(rep, covariate, sharded.n_haps // 2)
    parts = [fetch_async(dual_chunk_tables(chunk, qpheno[d], covar[d], *th,
                                           sharded.n_haps))
             for d, chunk in enumerate(_shard_chunks(
                 sharded, mesh, rep, binary_phenotype))]
    return _results(parts, sharded)


def quantitative_analyze_sharded(sharded: ShardedChromosome,
                                 phenotype: np.ndarray, covar,
                                 mesh: SnarlMesh, min_individuals: int,
                                 min_haplotypes: int, maf_threshold: float,
                                 return_tables: bool = False,
                                 replicated: Optional[Replicated] = None
                                 ) -> ShardedResult:
    """``vcf -q`` with the snarls sharded over ``mesh``: per shard the
    design (Q1), OLS (Q2) and the t tail (Q3).  ``return_tables`` keeps
    the -T table view on the shards' devices (``.tables``)."""
    rep = replicated or Replicated(mesh)
    th = (min_individuals, min_haplotypes, maf_threshold)
    pheno = rep.get("quantitative phenotype", phenotype, _f64)
    cov = _covariates(rep, covar, sharded.n_haps // 2)
    parts = [quantitative_analyze_chunk(chunk, pheno[d], cov[d], *th,
                                        sharded.n_haps, tables=return_tables)
             for d, chunk in enumerate(_shard_chunks(sharded, mesh, rep))]
    return _results(parts, sharded, return_tables)


def lmm_analyze_sharded(sharded: ShardedChromosome, lmm_ctx, covar,
                        mesh: SnarlMesh, min_individuals: int,
                        min_haplotypes: int, maf_threshold: float,
                        return_tables: bool = False,
                        replicated: Optional[Replicated] = None
                        ) -> ShardedResult:
    """The mixed model (``vcf -q -k --lmm``) with the snarls sharded over
    ``mesh``: per shard the all-rows design, the rotation GEMM and OLS
    against the rotated phenotype (K14), then the t tail; the rotation and
    the rotated phenotype (``stats.lmm.LmmContext``) replicated."""
    rep = replicated or Replicated(mesh)
    th = (min_individuals, min_haplotypes, maf_threshold)
    rot = rep.get("rotation", lmm_ctx, lambda c: _f64(c.rot))
    y_rot = rep.get("rotated phenotype", lmm_ctx, lambda c: _f64(c.y_rot))
    cov = _covariates(rep, covar, sharded.n_haps // 2)
    parts = [lmm_analyze_chunk(chunk, rot[d], y_rot[d], cov[d], *th,
                               sharded.n_haps, tables=return_tables)
             for d, chunk in enumerate(_shard_chunks(sharded, mesh, rep))]
    return _results(parts, sharded, return_tables)


def binary_covar_analyze_sharded(sharded: ShardedChromosome,
                                 binary_phenotype: np.ndarray,
                                 mesh: SnarlMesh, min_individuals: int,
                                 min_haplotypes: int, maf_threshold: float,
                                 return_tables: bool = False,
                                 replicated: Optional[Replicated] = None
                                 ) -> ShardedResult:
    """``vcf -b -c`` with the snarls sharded over ``mesh``: per shard the
    design without covariates (as the reference's model) and IRLS
    logistic regression (K11)."""
    rep = replicated or Replicated(mesh)
    th = (min_individuals, min_haplotypes, maf_threshold)
    case = rep.get("case indicator", binary_phenotype,
                   lambda ph: np.asarray(ph).astype(np.float64))
    parts = [binary_covar_analyze_chunk(chunk, case[d], *th, sharded.n_haps,
                                        tables=return_tables)
             for d, chunk in enumerate(_shard_chunks(sharded, mesh, rep))]
    return _results(parts, sharded, return_tables)


class ShardedPermState:
    """One block of snarls on the mesh for the permutation pass: each
    shard's path tables uploaded once (the words replicated), and the
    permutation-invariant stages computed once per shard when first asked
    for and kept on its device for every job of the block: the membership
    words (K1), the quantitative design per (thresholds, covariates) and
    the score test's invariants per (thresholds, reduced fit)."""

    def __init__(self, sharded: ShardedChromosome, mesh: SnarlMesh,
                 replicated: Optional[Replicated] = None):
        self.sharded = sharded
        self.mesh = mesh
        self.rep = replicated or Replicated(mesh)
        self.chunks = _shard_chunks(sharded, mesh, self.rep)
        W = int(sharded.words.shape[1])
        tails = self.rep.get("tail", sharded.words, lambda w: tail_mask_words(
            sharded.n_haps, W).view(np.int32))
        for chunk, tail in zip(self.chunks, tails):
            chunk.tail = tail
        self._mem = None
        self._design: Dict = {}     # (th, covariate key) -> per shard
        self._score: Dict = {}      # (th, Z, w) -> per shard

    def membership(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per shard (membership words int32 [P, W], g_all int32 [P])."""
        if self._mem is None:
            self._mem = [perm_membership(c.words, c.path_idx, c.path_valid,
                                         c.tail) for c in self.chunks]
        return self._mem

    def design(self, covar, th: Thresholds) -> List[Dict[str, torch.Tensor]]:
        """Per shard the design's X, used, ncols and bad = filtered |
        degenerate, once per (thresholds, covariates)."""
        key = (th, None if covar is None
               else (np.shape(covar), _f64(covar).tobytes()))
        got = self._design.get(key)
        if got is None:
            cov = _covariates(self.rep, covar, self.sharded.n_haps // 2)
            got = []
            for chunk, c in zip(self.chunks, cov):
                d = quant_design(chunk, c, *th, self.sharded.n_haps)
                got.append({"X": d["X"], "used": d["used"],
                            "ncols": d["ncols"],
                            "bad": d["filtered"] | d["degenerate"]})
            self._design[key] = got
        return got

    def score_pieces(self, Z: np.ndarray, w: np.ndarray, th: Thresholds
                     ) -> List[Tuple[torch.Tensor, ...]]:
        """Per shard (D, used, V^-1, df, allbad) of the covariate-adjusted
        score test, once per (thresholds, reduced fit)."""
        key = (th, Z.shape, Z.tobytes(), w.tobytes())
        got = self._score.get(key)
        if got is None:
            Zs = self.rep.get("reduced design", Z, _f64)
            ws = self.rep.get("working weights", w, _f64)
            got = []
            for d, x in enumerate(self.design(None, th)):
                D, Vinv, df, allbad = score_precompute(
                    x["X"], x["used"], x["ncols"], x["bad"], Zs[d], ws[d])
                got.append((D, x["used"], Vinv, df, allbad))
            self._score[key] = got
        return got


def _perm_results(parts: List[torch.Tensor],
                  sharded: ShardedChromosome) -> np.ndarray:
    """[K, S] p-values in global snarl order from each shard's [K,
    S_local] (stoat_tpu's _unshard_perm)."""
    return ShardedResult([fetch_async({"p": p}) for p in parts],
                         sharded.shard_sizes, axis=1)["p"]


def binary_perm_pvalues_sharded(sharded: ShardedChromosome,
                                masks: np.ndarray, mesh: SnarlMesh,
                                min_individuals: int, min_haplotypes: int,
                                maf_threshold: float,
                                state: Optional[ShardedPermState] = None,
                                replicated: Optional[Replicated] = None
                                ) -> np.ndarray:
    """[K, S] sanitised chi-squared p-values of K packed case masks (uint32
    [K, W]) with the snarls sharded over ``mesh``: per shard the block's
    membership (once, ``state``), K15 and the tail (K5), as the
    single-device pass (``pipeline/permutation.py``).  Every row runs in
    one batch, as there."""
    st = state if state is not None else ShardedPermState(
        sharded, mesh, replicated)
    th = (min_individuals, min_haplotypes, maf_threshold)
    rows = st.rep.get("permutation masks", masks, _words_i32)
    return _perm_results(
        [binary_perm_pvalues(*perm_binary_stats(
            mem, g_all, rows[d], st.chunks[d].snarl_path_idx, *th))
         for d, (mem, g_all) in enumerate(st.membership())], sharded)


def quant_perm_pvalues_sharded(sharded: ShardedChromosome,
                               phenos: np.ndarray, covar, mesh: SnarlMesh,
                               min_individuals: int, min_haplotypes: int,
                               maf_threshold: float,
                               state: Optional[ShardedPermState] = None,
                               replicated: Optional[Replicated] = None
                               ) -> np.ndarray:
    """[K, S] sanitised OLS-t p-values of K phenotype rows (float64 [K,
    N]; Freedman–Lane rows with ``covar``) with the snarls sharded over
    ``mesh``: per shard the design (once, ``state``), K16a and the t tail
    (K10)."""
    st = state if state is not None else ShardedPermState(
        sharded, mesh, replicated)
    th = (min_individuals, min_haplotypes, maf_threshold)
    rows = st.rep.get("permutation phenotypes", phenos, _f64)
    parts = []
    for d, x in enumerate(st.design(covar, th)):
        t1, df = perm_ols_stats(x["X"], x["used"], x["ncols"], rows[d])
        parts.append(quant_perm_pvalues(t1, df, x["bad"]))
    return _perm_results(parts, sharded)


def logistic_score_perm_sharded(sharded: ShardedChromosome, Z: np.ndarray,
                                w: np.ndarray, e_batch: np.ndarray,
                                mesh: SnarlMesh, min_individuals: int,
                                min_haplotypes: int, maf_threshold: float,
                                state: Optional[ShardedPermState] = None,
                                replicated: Optional[Replicated] = None
                                ) -> np.ndarray:
    """[K, S] sanitised covariate-adjusted logistic score-test p-values of
    K residual rows (float64 [K, N]) with the snarls sharded over
    ``mesh``: per shard the invariants (once, ``state``), K16c and the
    tail (K5)."""
    st = state if state is not None else ShardedPermState(
        sharded, mesh, replicated)
    th = (min_individuals, min_haplotypes, maf_threshold)
    rows = st.rep.get("permutation residuals", e_batch, _f64)
    pieces = st.score_pieces(_f64(Z), _f64(w), th)
    return _perm_results(
        [score_perm_pvalues(score_perm_stats(D, used, Vinv, rows[d]), df,
                            allbad)
         for d, (D, used, Vinv, df, allbad) in enumerate(pieces)], sharded)


def eqtl_regress_pairs_sharded(design: Dict[str, torch.Tensor],
                               pair_snarl, pair_gene, expr: np.ndarray,
                               mesh: SnarlMesh,
                               replicated: Optional[Replicated] = None
                               ) -> Dict[str, np.ndarray]:
    """OLS of (snarl, gene) pairs with the pair axis split over ``mesh``.

    ``design`` is one chunk's eQTL design on one device
    (``pipeline/quantitative.py eqtl_design_for_chromosome``); pair b
    regresses ``expr[pair_gene[b]]`` (float64 [G, N], replicated) on snarl
    ``pair_snarl[b]``'s design.  The pairs, grouped by snarl, are cut into
    ``len(mesh)`` ranges of about ceil(B / D) pairs on snarl boundaries;
    each range runs K13 and the t tail on its device with the design rows
    of its snarls.  Returns p, beta, se and r2 [B] in the given pair
    order."""
    rep = replicated or Replicated(mesh)
    ps = np.asarray(pair_snarl, np.int64)
    pg = np.asarray(pair_gene, np.int32)
    B = ps.shape[0]
    S = int(design["X"].shape[0])
    order = np.argsort(ps, kind="stable")
    ps, pg = ps[order], pg[order]
    off = np.zeros(S + 1, np.int64)
    np.cumsum(np.bincount(ps, minlength=S), out=off[1:])
    per = -(-B // len(mesh))
    cuts = [0, *(int(np.searchsorted(off, d * per)) for d in
                 range(1, len(mesh))), S]
    cuts = np.maximum.accumulate(np.minimum(cuts, S))
    genes = rep.get("expression", expr, _f64)
    parts, sizes = [], []
    for d, dev in enumerate(mesh.devices):
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        b_lo, b_hi = int(off[lo]), int(off[hi])
        if b_hi == b_lo:
            continue
        rows = {k: design[k][lo:hi].to(dev)
                for k in ("X", "used", "ncols", "degenerate")}
        pair_off = upload((off[lo:hi + 1] - b_lo).astype(np.int32), dev)
        t1, df_res, beta, se, r2 = eqtl_ols_stats(
            rows["X"], rows["used"], rows["ncols"], pair_off,
            upload(pg[b_lo:b_hi], dev), genes[d])
        deg = rows["degenerate"][pair_snarls(pair_off, b_hi - b_lo)]
        parts.append(fetch_async(student_t_pvalues(t1, df_res, deg, beta, se,
                                                   r2)))
        sizes.append(b_hi - b_lo)
    keys = ("p", "beta", "se", "r2")
    if not parts:
        return {k: np.zeros(0, np.float64) for k in keys}
    got = ShardedResult(parts, sizes)
    back = np.empty(B, np.int64)
    back[order] = np.arange(B)
    return {k: got[k][back] for k in keys}
