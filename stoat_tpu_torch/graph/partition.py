"""Graph mode's host partitioning helpers (the Python path of ``stoat graph``).

Copies of stoat_tpu/graph/association.py's walk-set partitioner
(partitioner.cpp:36-268), its native twin over every regular snarl at
once, the regular-snarl test, the min/max traversal lengths written as
PATH_LENGTHS and the FASTA writer (writer.cpp:89-178).  The device half of
graph mode, which calls them, is graph/association.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from stoat_tpu_torch.graph.gfa import GfaGraph, GfaPath, Handle, flip
from stoat_tpu_torch.graph.snarls import SnarlForest

__all__ = ["PathPartitioner", "flat_steps"]


class PathPartitioner:
    """Walk-set sample partitioning over GFA paths."""

    def __init__(self, g: GfaGraph, paths: Sequence[GfaPath]):
        self.g = g
        # (sample, haplotype) -> list of step lists (one per path)
        self.sample_paths: List[Tuple[Tuple[str, int], List[Handle],
                                      List[int]]] = []
        # node id -> [(path index, step index), ...] built LAZILY: the
        # native partitioner (graph_core) builds its own index, so the
        # Python dict (seconds at 100k-snarl scale) is only paid when the
        # Python refinement actually runs (irregular snarls, TRACE)
        self.__node_steps: Optional[Dict[int,
                                         List[Tuple[int, int]]]] = None
        for pi, p in enumerate(paths):
            offsets = []
            pos = 0
            for step in p.steps:
                offsets.append(pos)
                pos += g.node_length(step[0])
            self.sample_paths.append(((p.sample, p.haplotype), p.steps,
                                      offsets))

    @property
    def _node_steps(self) -> Dict[int, List[Tuple[int, int]]]:
        if self.__node_steps is None:
            index: Dict[int, List[Tuple[int, int]]] = {}
            for pi, (_key, steps, _off) in enumerate(self.sample_paths):
                for si, step in enumerate(steps):
                    index.setdefault(step[0], []).append((pi, si))
            self.__node_steps = index
        return self.__node_steps

    def _outgoing_edge_lists(self, handle: Handle) -> List[Optional[tuple]]:
        """Per sample path: the ordered tuple of edges leaving ``handle``
        (partitioner.cpp:91-198), or None if the path avoids this node."""
        per_path: Dict[int, List[Tuple[int, Tuple[int, bool]]]] = {}
        for pi, i in self._node_steps.get(handle[0], ()):
            _key, steps, offsets = self.sample_paths[pi]
            st = steps[i]
            go_forwards = st[1] == handle[1]
            j = i + 1 if go_forwards else i - 1
            if j < 0 or j >= len(steps):
                continue
            nxt = steps[j]
            per_path.setdefault(pi, []).append(
                (offsets[i], (nxt[0], nxt[1])))
        out: List[Optional[tuple]] = []
        for pi in range(len(self.sample_paths)):
            crossings = per_path.get(pi)
            if crossings:
                crossings.sort(key=lambda x: x[0])
                out.append(tuple(e for _off, e in crossings))
            else:
                out.append(None)
        return out

    def partition_samples_in_snarl(self, forest: SnarlForest,
                                   snarl_idx: int,
                                   regular: bool) -> List[Set[str]]:
        snarl = forest.snarls[snarl_idx]
        n = len(self.sample_paths)
        old_sets = [0] * n
        set_count = 1

        def refine(handle: Handle) -> None:
            nonlocal old_sets, set_count
            edge_lists = self._outgoing_edge_lists(handle)
            inter: Dict[tuple, int] = {}
            inter_sets = [0] * n
            next_inter = 1
            for i, el in enumerate(edge_lists):
                if el is None:
                    continue
                if el not in inter:
                    inter[el] = next_inter
                    next_inter += 1
                inter_sets[i] = inter[el]
            mapping: Dict[Tuple[int, int], int] = {(0, 0): 0}
            new_count = 1
            new_sets = [0] * n
            for i in range(n):
                key = (old_sets[i], inter_sets[i])
                if key not in mapping:
                    mapping[key] = new_count
                    new_count += 1
                new_sets[i] = mapping[key]
            old_sets = new_sets
            set_count = new_count

        refine(snarl.start)

        if not regular:
            # every child unit, both directions
            view_children = self._child_handles(forest, snarl_idx)
            for h in view_children:
                refine(h)

        sets: List[Set[str]] = [set() for _ in range(set_count - 1)]
        for i, (key, _steps, _off) in enumerate(self.sample_paths):
            if old_sets[i] != 0:
                sets[old_sets[i] - 1].add(key[0])
        return [s for s in sets if s]

    def _child_handles(self, forest: SnarlForest,
                       snarl_idx: int) -> List[Handle]:
        snarl = forest.snarls[snarl_idx]
        hidden: Set[int] = set()
        chain_handles: List[Handle] = []
        for chain in forest.chains_of_parent(snarl_idx):
            first = forest.snarls[chain[0]]
            last = forest.snarls[chain[-1]]
            for si in chain:
                s = forest.snarls[si]
                hidden |= set(s.interior_nodes)
                hidden.add(s.start_node)
                hidden.add(s.end_node)
            chain_handles.append(last.end)            # rightward
            chain_handles.append(flip(first.start))   # leftward
        handles: List[Handle] = []
        for nid in sorted(set(snarl.interior_nodes) - hidden):
            handles.append((nid, False))
            handles.append((nid, True))
        handles.extend(chain_handles)
        return handles


def flat_steps(forest: SnarlForest, partitioner: PathPartitioner):
    """The native cores' view of the sample paths and snarls: (sorted
    sample names, steps uint64 (node id << 1 | reverse) of every path one
    after the other, offsets int64 [paths + 1], each path's sample index
    int32, each snarl's start handle uint64 (node id << 1 | orientation))."""
    names = sorted({key[0] for key, _s, _o in partitioner.sample_paths})
    name_to_id = {n: i for i, n in enumerate(names)}
    steps: List[int] = []
    offsets = [0]
    path_sample = []
    for key, psteps, _off in partitioner.sample_paths:
        steps.extend((st[0] << 1) | int(st[1]) for st in psteps)
        offsets.append(len(steps))
        path_sample.append(name_to_id[key[0]])
    starts = np.array([(s.start[0] << 1) | int(s.start[1])
                       for s in forest.snarls], np.uint64)
    return (names, np.array(steps, np.uint64), np.array(offsets, np.int64),
            np.array(path_sample, np.int32), starts)


class _NativePartitions:
    """Per-snarl walk-set partition counts from the native core.

    Precomputes the start-bound refinement for EVERY snarl in one
    parallel native pass (graph_core.cpp stoat_graph_partitions) — the
    graph-mode hot loop that is otherwise a per-snarl Python walk.
    Valid exactly for REGULAR snarls (start-edge refinement only);
    irregular snarls fall back to the Python partitioner."""

    def __init__(self, forest: SnarlForest, partitioner: PathPartitioner,
                 case_set: Set[str], control_set: Set[str]):
        from stoat_tpu_torch.native import graph_partitions_native

        names, steps, offsets, path_sample, starts = flat_steps(
            forest, partitioner)
        sample_case = np.array([n in case_set for n in names], np.uint8)
        got = graph_partitions_native(steps, offsets, path_sample,
                                      len(names), starts, sample_case)
        if got is None:
            raise RuntimeError("native graph core unavailable")
        self.offs, self.n_case, self.n_ctrl, self.rep = got
        self.names = names
        self.n_case_total = sum(1 for n in names if n in case_set)
        self.n_ctrl_total = len(names) - self.n_case_total

    def counts(self, snarl_idx: int):
        """[(n_in_case, n_in_control, rep_sample_name), ...] in the
        Python partitioner's set order."""
        lo, hi = int(self.offs[snarl_idx]), int(self.offs[snarl_idx + 1])
        return [(int(self.n_case[i]), int(self.n_ctrl[i]),
                 self.names[int(self.rep[i])]) for i in range(lo, hi)]


def _is_regular_snarl(g: GfaGraph, forest: SnarlForest,
                      snarl_idx: int) -> bool:
    """Heuristic mirror of bdsg's is_regular_snarl: every interior node
    connects only the start bound to the end bound, forward-only."""
    snarl = forest.snarls[snarl_idx]
    if forest.snarls[snarl_idx].children:
        return False
    bounds = {snarl.start_node, snarl.end_node}
    for nid in snarl.interior_nodes:
        for orient in (False, True):
            for nxt in g.successors((nid, orient)):
                if nxt[0] not in bounds and nxt[0] not in snarl.interior_nodes:
                    return False
                if nxt[0] in snarl.interior_nodes:
                    return False  # child-child edge -> irregular
    # reversals at the bounds make a snarl irregular
    for h in (snarl.start, flip(snarl.end)):
        for nxt in g.successors(h):
            if nxt[0] == h[0]:
                return False
    return True


def _snarl_min_max_len(g: GfaGraph, forest: SnarlForest,
                       snarl_idx: int) -> Tuple[int, int]:
    """Min/max interior sequence length over SIMPLE start→end traversals.

    Matches SnarlDistanceIndex::{minimum,maximum}_length semantics (the
    reference prints these as PATH_LENGTHS, graph_path_association_finder
    .cpp:63-71): boundary nodes excluded, loops not unrolled — pinned by
    graph_simu_test.cpp (loop_with_indel 6_1 -> "3,4")."""
    snarl = forest.snarls[snarl_idx]
    interior = snarl.interior_nodes
    end_node = snarl.end_node
    best_min, best_max = None, None
    budget = 200000
    stack = [(snarl.start, frozenset(), 0)]
    while stack and budget > 0:
        budget -= 1
        h, visited, total = stack.pop()
        for v in g.successors(h):
            if v[0] == end_node:
                best_min = total if best_min is None else min(best_min,
                                                              total)
                best_max = total if best_max is None else max(best_max,
                                                              total)
            elif v[0] in interior and v[0] not in visited:
                stack.append((v, visited | {v[0]},
                              total + g.node_length(v[0])))
    if best_min is None:
        return 0, 0
    return best_min, best_max



def _write_fasta_partitions(g: GfaGraph, forest: SnarlForest, snarl_idx: int,
                            samples_to_write: Dict[str, bool], out_fh,
                            partitioner: PathPartitioner,
                            reference_sample: str = "") -> None:
    """FASTA output: the sequence each chosen sample takes through the
    snarl, headers ``>snarl:a-b|<ref range>|<sample range>``
    (writer.cpp:89-178)."""
    snarl = forest.snarls[snarl_idx]
    name = f"snarl:{snarl.start_node}-{snarl.end_node}"
    bounds = {snarl.start_node, snarl.end_node}
    interior = snarl.interior_nodes

    def traversals(steps):
        """All [i, j] step pairs where a path crosses the snarl: both ends
        on boundary nodes (either direction), every step between strictly
        interior.  A sample looping back through the snarl yields one
        record per crossing (graph_simu_test.cpp:393-410 pins two records
        for path1 through loop_with_indel's 2-4)."""
        idxs = [i for i, st in enumerate(steps) if st[0] in bounds]
        for i, j in zip(idxs, idxs[1:]):
            if all(steps[k][0] in interior for k in range(i + 1, j)):
                yield i, j

    # reference range through the snarl ("NOREF:?:?" when absent,
    # writer.cpp:106)
    ref_coordinates = "NOREF:?:?"
    for path in g.paths:
        if reference_sample and path.sample != reference_sample and \
                path.name != reference_sample:
            continue
        if not reference_sample and not path.is_reference:
            continue
        pos = 0
        offs = []
        for st in path.steps:
            offs.append(pos)
            pos += g.node_length(st[0])
        for si, ei in traversals(path.steps):
            start_off = offs[si] + g.node_length(path.steps[si][0])
            ref_coordinates = f"{path.name}:{start_off}-{offs[ei]}"
            break
        if ref_coordinates != "NOREF:?:?":
            break

    for key, steps, offsets in partitioner.sample_paths:
        sample = key[0]
        if samples_to_write and sample not in samples_to_write:
            continue
        for si, ei in traversals(steps):
            seq = "".join(g.node_seq(steps[i]) for i in range(si + 1, ei))
            start_off = offsets[si] + g.node_length(steps[si][0])
            end_off = offsets[ei]
            out_fh.write(f">{name}|{ref_coordinates}|"
                         f"{sample}:{start_off}-{end_off}\n")
            for i in range(0, len(seq), 80):
                out_fh.write(seq[i:i + 80] + "\n")
            if len(seq) == 0:
                out_fh.write("\n")

