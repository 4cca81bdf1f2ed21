"""Snarl decomposition from the graph structure (no .dist file needed).

The reference walks a precomputed bdsg::SnarlDistanceIndex
(snarl_data_t.cpp:417-532).  Here snarls are computed directly from the
bidirected graph using the ultrabubble separation criterion: a snarl is a
pair of node *sides* (a_in, b_in) such that the interior node set U touches
the rest of the graph only through those two sides.  For every candidate
entrance (a branching handle, or one leading into locally-cyclic/inverting
structure) we grow the closure reachable from the entrance side and test
successive exit candidates in BFS order; the first separable pair is the
minimal snarl at that entrance.

This is orientation-aware (a side-based, not flow-based, test), so it
handles inversion bubbles, deletion edges, cyclic interiors, and tips —
the cases where classic directed-superbubble flooding breaks down on
bidirected graphs.

Snarls nest by interior containment into a tree; sibling snarls sharing a
boundary node link into chains (the bdsg chain structure that the path
renderer collapses to ``*``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from stoat_tpu_torch.graph.gfa import GfaGraph, Handle, flip

__all__ = ["Snarl", "SnarlForest", "find_snarls"]

# A "side" of node m is identified by the handle that EXITS through it:
# (m, False) exits the right side, (m, True) exits the left side.  An entry
# handle (m, o) enters through the side keyed (m, not o).


def _entry_side(entry: Handle) -> Handle:
    return (entry[0], not entry[1])


def _side_endpoints(g: GfaGraph, side: Handle) -> List[Handle]:
    """All far-end entry handles of edges attached to this side."""
    return g.successors(side)


@dataclass
class Snarl:
    """A snarl: start handle faces into the snarl; end handle is the
    orientation in which a traversal leaves the snarl."""

    start: Handle
    end: Handle
    interior_nodes: FrozenSet[int]
    parent: Optional[int] = None
    children: List[int] = field(default_factory=list)
    depth: int = 1
    chain_id: int = -1

    @property
    def start_node(self) -> int:
        return self.start[0]

    @property
    def end_node(self) -> int:
        return self.end[0]

    @property
    def id_str(self) -> str:
        return f"{self.start_node}_{self.end_node}"


@dataclass
class SnarlForest:
    snarls: List[Snarl]
    chains: List[List[int]]

    def top_level(self) -> List[int]:
        return [i for i, s in enumerate(self.snarls) if s.parent is None]

    def chains_of_parent(self, parent_idx: Optional[int]) -> List[List[int]]:
        """Chains whose snarls have the given parent (indexed once)."""
        cache = getattr(self, "_chains_by_parent", None)
        if cache is None:
            cache = {}
            for chain in self.chains:
                if chain:
                    cache.setdefault(self.snarls[chain[0]].parent,
                                     []).append(chain)
            self._chains_by_parent = cache
        return cache.get(parent_idx, [])


def _test_pair(g: GfaGraph, a: Handle, b_node: int,
               budget: int = 1 << 30
               ) -> Optional[Tuple[FrozenSet[int], Handle]]:
    """Test whether (a, b_node) bounds a snarl.  ``a`` is the entrance
    handle (facing in); its inside side is the side it exits through.

    Returns (interior U, end_handle) or None.
    """
    a_node = a[0]
    a_inside = (a_node, a[1])          # side key of the entrance side
    if b_node == a_node:
        return None

    U: Set[int] = set()
    b_faces: Set[Handle] = set()       # side keys of b touched from inside
    queue = deque()
    for v in g.successors(a):
        m = v[0]
        if m == a_node:
            # cycle straight back into the entrance: only legal if it
            # re-enters through the inside side
            if _entry_side(v) != a_inside:
                return None
            continue
        if m == b_node:
            b_faces.add(_entry_side(v))
            if len(b_faces) > 1:
                return None            # early abort: b crossed on 2 sides
            continue
        queue.append(m)

    while queue:
        u = queue.popleft()
        if u in U:
            continue
        U.add(u)
        if len(U) > budget or len(U) > _MAX_INTERIOR:
            return None                # closure exploded: not this pair
        for side_o in (False, True):
            side = (u, side_o)
            for v in _side_endpoints(g, side):
                m = v[0]
                if m == a_node:
                    if _entry_side(v) != a_inside:
                        return None     # touches the entrance's outside
                    continue
                if m == b_node:
                    b_faces.add(_entry_side(v))
                    if len(b_faces) > 1:
                        return None     # early abort
                    continue
                if m not in U:
                    queue.append(m)

    if len(b_faces) != 1:
        return None
    b_inside = next(iter(b_faces))

    def ok_inside_side(side: Handle, own_inside: Handle,
                       other_node: int, other_inside: Handle) -> bool:
        for v in _side_endpoints(g, side):
            m = v[0]
            es = _entry_side(v)
            if m in U:
                continue
            if m == side[0] and es == own_inside:
                continue                 # self-loop on the inside side
            if m == other_node and es == other_inside:
                continue
            return False
        return True

    def ok_outside_side(side: Handle, other_node: int,
                        other_inside: Handle) -> bool:
        for v in _side_endpoints(g, side):
            m = v[0]
            es = _entry_side(v)
            if m in U:
                return False
            if m == other_node and es == other_inside:
                return False
        return True

    a_outside = (a_node, not a[1])
    b_outside = (b_inside[0], not b_inside[1])
    if not ok_inside_side(a_inside, a_inside, b_node, b_inside):
        return None
    if not ok_inside_side(b_inside, b_inside, a_node, a_inside):
        return None
    if not ok_outside_side(a_outside, b_node, b_inside):
        return None
    if not ok_outside_side(b_outside, a_node, a_inside):
        return None
    if not U and len(g.successors(a)) < 2:
        return None                      # trivial single edge

    # end handle: traversal leaves b through its outside side; the handle
    # exiting that side is (b, not b_inside_orientation) flipped... the
    # side key (b, o) is exited by handle (b, o); leaving through the
    # outside side uses handle b_outside.
    end_handle = b_outside
    return frozenset(U), end_handle


_MAX_EXIT_TRIES = 64
# Closure-size cap per candidate pair: a snarl interior larger than this
# would be rejected downstream by the children threshold anyway.
_MAX_INTERIOR = 50000


def _find_snarl_from(g: GfaGraph, a: Handle, forbidden: Set[int],
                     max_tries: int = _MAX_EXIT_TRIES
                     ) -> Optional[Tuple[int, FrozenSet[int], Handle]]:
    """BFS exit candidates from entrance ``a``; first separable pair wins.

    ``forbidden`` holds reference-path terminal nodes: a pair whose
    interior swallows a path terminus is the *complement* of a real snarl
    (the graph boundary makes complements separable too) and is rejected —
    this roots the decomposition the way vg's cactus rooting does.
    """
    order: List[int] = []
    seen: Set[int] = {a[0]}
    queue = deque()
    for v in g.successors(a):
        if v[0] not in seen:
            seen.add(v[0])
            order.append(v[0])
            queue.append(v)
    tried = 0
    qi = 0
    while qi < len(order) and tried < max_tries:
        b = order[qi]
        qi += 1
        tried += 1
        # a minimal snarl's interior is on the order of the BFS frontier
        # explored so far; budget the closure accordingly so failing
        # candidates abort early instead of flooding the whole graph
        res = _test_pair(g, a, b, budget=16 * len(order) + 64)
        if res is not None:
            U, end_handle = res
            if not (U & forbidden):
                return b, U, end_handle
        # expand BFS one layer from b
        for side_o in (False, True):
            for v in _side_endpoints(g, (b, side_o)):
                if v[0] not in seen:
                    seen.add(v[0])
                    order.append(v[0])
    return None


def _cyclic_nodes(g: GfaGraph) -> Set[int]:
    """Nodes whose handles sit in a nontrivial SCC of the orientation
    digraph (or that have a self edge) — the only places where a
    single-successor entrance can still open a snarl."""
    index: Dict[Handle, int] = {}
    lowlink: Dict[Handle, int] = {}
    on_stack: Set[Handle] = set()
    stack: List[Handle] = []
    counter = [0]
    cyclic: Set[int] = set()

    vertices = [(nid, o) for nid in g.node_ids() for o in (False, True)]
    for root in vertices:
        if root in index:
            continue
        work = [(root, iter(g.successors(root)))]
        index[root] = lowlink[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w == v:
                    cyclic.add(v[0])  # self edge
                elif w not in index:
                    index[w] = lowlink[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(g.successors(w))))
                    advanced = True
                    break
                elif w in on_stack:
                    lowlink[v] = min(lowlink[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[v])
            if lowlink[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    for w in comp:
                        cyclic.add(w[0])
    return cyclic


def find_snarls(g: GfaGraph) -> SnarlForest:
    # ---- candidate entrances -------------------------------------------
    # Strong candidates (branching handles) get the full exit search.
    # Weak ones (single successor with a busy entry side) are only worth
    # testing when that successor sits in cyclic structure — in a DAG they
    # are just merge points seen from upstream.
    cyclic = _cyclic_nodes(g)
    candidates: List[Tuple[Handle, int]] = []
    for nid in g.node_ids():
        for o in (False, True):
            h = (nid, o)
            succs = g.successors(h)
            if len(succs) >= 2:
                # the true exit of a P-branch bubble appears after P
                # BFS candidates: a fixed 64 cap made >64-allele sites
                # vanish silently (in neither output file)
                candidates.append(
                    (h, max(_MAX_EXIT_TRIES, 2 * len(succs) + 16)))
            elif len(succs) == 1:
                v = succs[0]
                entered = _entry_side(v)
                if v[0] in cyclic and \
                        len(_side_endpoints(g, entered)) >= 2:
                    candidates.append((h, 8))

    # ranks over EVERY reference path (offset per path so ranks stay
    # unique): stopping at the first path left every later chromosome's
    # snarls without reference orientation (reversed ids on chr2+)
    ref_order: Dict[int, int] = {}
    base = 0
    for path in g.paths:
        if path.is_reference:
            for rank, step in enumerate(path.steps):
                ref_order.setdefault(step[0], base + rank)
            base += len(path.steps)
    if not ref_order and g.paths:
        for path in g.paths:
            for rank, step in enumerate(path.steps):
                ref_order.setdefault(step[0], base + rank)
            base += len(path.steps)

    # Reference-path termini root the decomposition (see
    # _find_snarl_from).  Sample paths may legitimately end mid-graph, so
    # only reference paths count (all paths when none is flagged).
    forbidden: Set[int] = set()
    ref_paths = [p for p in g.paths if p.is_reference] or g.paths
    for path in ref_paths:
        if path.steps:
            forbidden.add(path.steps[0][0])
            forbidden.add(path.steps[-1][0])

    chosen: Dict[Tuple[FrozenSet[int], FrozenSet[int]],
                 Tuple[Handle, Handle, FrozenSet[int]]] = {}
    for a, tries in candidates:
        res = _find_snarl_from(g, a, forbidden, tries)
        if res is None:
            continue
        b, U, end_handle = res
        key = (frozenset((a[0], b)), U)
        if key in chosen:
            s0 = chosen[key][0]
            # prefer the orientation following the reference path
            rs, rt = ref_order.get(a[0]), ref_order.get(b)
            r0 = ref_order.get(s0[0])
            if rs is not None and rt is not None and rs <= rt and \
                    (r0 is None or r0 > rs or s0[0] != a[0]):
                chosen[key] = (a, end_handle, U)
            continue
        chosen[key] = (a, end_handle, U)

    snarls: List[Snarl] = []
    for a, end_handle, U in chosen.values():
        rs, rt = ref_order.get(a[0]), ref_order.get(end_handle[0])
        if rs is not None and rt is not None and rs > rt:
            a, end_handle = flip(end_handle), flip(a)
        # NOTE on cyclic snarls: vg's cactus build reports some snarls
        # with cyclic structure in the opposite orientation (e.g.
        # loop_with_indel's top snarl is 6_1 in graph_simu_test.cpp:334
        # yet loop_plus's top is 2_8 in snarl_data_t_unit.cpp:314 — two
        # near-isomorphic graphs, opposite orientations).  The order is
        # an artifact of vg's internal anchoring, not derivable from the
        # graph; stoat-tpu always reports reference-path orientation
        # (documented divergence, DESIGN.md §7).
        snarls.append(Snarl(start=a, end=end_handle, interior_nodes=U))

    # ---- nesting --------------------------------------------------------
    # parent = smallest-interior snarl containing both bounds as interior.
    # Index node -> containing snarls to avoid the O(n^2) pairwise scan.
    containing: Dict[int, List[int]] = {}
    for j, sj in enumerate(snarls):
        for nid in sj.interior_nodes:
            containing.setdefault(nid, []).append(j)
    for i, si in enumerate(snarls):
        cand = set(containing.get(si.start_node, ())) & \
            set(containing.get(si.end_node, ()))
        cand.discard(i)
        if cand:
            best = min(cand,
                       key=lambda j: (len(snarls[j].interior_nodes), j))
            si.parent = best
            snarls[best].children.append(i)

    def set_depth(i: int, d: int) -> None:
        snarls[i].depth = d
        for c in snarls[i].children:
            set_depth(c, d + 1)

    for i, s in enumerate(snarls):
        if s.parent is None:
            set_depth(i, 1)

    # ---- chains ---------------------------------------------------------
    chains: List[List[int]] = []
    by_parent: Dict[Optional[int], List[int]] = {}
    for i, s in enumerate(snarls):
        by_parent.setdefault(s.parent, []).append(i)

    for parent, sibs in by_parent.items():
        by_start = {snarls[i].start_node: i for i in sibs}
        by_end = {snarls[i].end_node: i for i in sibs}
        used: Set[int] = set()
        for i in sibs:
            if i in used:
                continue
            chain = [i]
            used.add(i)
            cur = i
            while True:
                nxt = by_start.get(snarls[cur].end_node)
                if nxt is None or nxt in used:
                    break
                chain.append(nxt)
                used.add(nxt)
                cur = nxt
            cur = i
            while True:
                prv = by_end.get(snarls[cur].start_node)
                if prv is None or prv in used:
                    break
                chain.insert(0, prv)
                used.add(prv)
                cur = prv
            cid = len(chains)
            chains.append(chain)
            for j in chain:
                snarls[j].chain_id = cid

    return SnarlForest(snarls=snarls, chains=chains)
