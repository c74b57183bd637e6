"""Maximum common subgraph search (McGregor 1982 backtracking with MARCS

The port's copy of timemachine_tpu/fe/mcgregor.py.
edge-correspondence refinement and best-first ordering).

Parity target: reference timemachine/fe/mcgregor.py. The search maximizes the
number of mapped EDGES (not atoms) — the right objective for alchemical
cores — with an `arcs_left` upper bound (min of live marcs rows/cols) as the
best-first heuristic, which guarantees the first leaves popped are optimal.

Reference: J.J. McGregor, "Backtrack search algorithms and the maximal common
subgraph problem", Softw. Pract. Exper. 12 (1982) 23-34.
"""

from __future__ import annotations

import heapq
import warnings
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

UNMAPPED = -1


class MaxVisitsWarning(UserWarning):
    pass


class NoMappingError(Exception):
    pass


@dataclass(frozen=True)
class MCSDiagnostics:
    total_nodes_visited: int
    total_leaves_visited: int
    core_size: int
    num_cores: int


class _Graph:
    def __init__(self, n_vertices: int, edges):
        self.n_vertices = n_vertices
        self.edges = np.asarray(edges).reshape(-1, 2)
        self.n_edges = len(self.edges)
        self.adj = np.zeros((n_vertices, n_vertices), dtype=bool)
        self.vertex_edges: list[list[int]] = [[] for _ in range(n_vertices)]
        for e, (i, j) in enumerate(self.edges):
            self.adj[i, j] = self.adj[j, i] = True
            self.vertex_edges[i].append(e)
            self.vertex_edges[j].append(e)
        self.ve_mask = np.zeros((n_vertices, self.n_edges), dtype=bool)
        for v, es in enumerate(self.vertex_edges):
            self.ve_mask[v, es] = True
        self.neighbors = [list(np.flatnonzero(self.adj[v])) for v in range(n_vertices)]

    def cc_constraints_violated(self, mapped_nodes, unvisited_nodes, max_ccs, min_cc_size):
        """True if the partial mapping can no longer satisfy the connected-
        component constraints (ref mcgregor.py:52-151): components are taken
        in the subgraph induced by mapped + unvisited nodes (demapped nodes
        can't rejoin)."""
        seen = set()
        n_ccs = 0
        for u in mapped_nodes:
            if u in seen:
                continue
            seen.add(u)
            cc_size = 1
            frontier = [u]
            while frontier:
                v = frontier.pop()
                for w in self.neighbors[v]:
                    if (w in mapped_nodes or w in unvisited_nodes) and w not in seen:
                        seen.add(w)
                        cc_size += 1
                        frontier.append(w)
            n_ccs += 1
            if cc_size < min_cc_size:
                return True
            if max_ccs is not None and n_ccs == max_ccs and not mapped_nodes.issubset(seen):
                return True
        return False


def _initial_marcs(g_a: _Graph, g_b: _Graph, predicate: np.ndarray) -> np.ndarray:
    """Edge pair (ea, eb) compatible iff endpoints can map in either
    orientation (ref mcgregor.py:183-200)."""
    src_a = g_a.edges[:, None, 0]
    dst_a = g_a.edges[:, None, 1]
    src_b = g_b.edges[None, :, 0]
    dst_b = g_b.edges[None, :, 1]
    return (predicate[src_a, src_b] & predicate[dst_a, dst_b]) | (predicate[src_a, dst_b] & predicate[dst_a, src_b])


def _refine_marcs(marcs, g_a: _Graph, g_b: _Graph, v_a: int, v_b: int) -> np.ndarray:
    """Zero out edge pairs inconsistent with the new assignment v_a -> v_b
    (v_b = UNMAPPED kills all rows of edges incident to v_a)
    (ref mcgregor.py:202-226)."""
    new = np.array(marcs)
    e_a = g_a.ve_mask[v_a]
    if v_b == UNMAPPED:
        new[e_a, :] = False
    else:
        e_b = g_b.ve_mask[v_b]
        new &= e_a[:, None] == e_b[None, :]
    return new


def _arcs_left(marcs) -> int:
    return int(min(marcs.any(1).sum(), marcs.any(0).sum()))


class _Node:
    __slots__ = ("a_to_b", "b_to_a", "marcs", "layer", "bound")

    def __init__(self, a_to_b, b_to_a, marcs, layer):
        self.a_to_b = a_to_b
        self.b_to_a = b_to_a
        self.marcs = marcs
        self.layer = layer
        self.bound = _arcs_left(marcs)

    def priority(self):
        return (-self.bound, -self.layer)

    def __lt__(self, other):
        return self.priority() < other.priority()


def _core_preserves_edges(g_a: _Graph, g_b: _Graph, v_a: int, v_b: int, a_to_b, b_to_a) -> bool:
    """enforce_core_core: a newly-mapped atom must not break any core-core
    bond in either direction (ref mcgregor.py:249-263)."""

    def ok(g1, g2, v1, map12):
        for e in g1.vertex_edges[v1]:
            i, j = g1.edges[e]
            mi, mj = map12[i], map12[j]
            if mi != UNMAPPED and mj != UNMAPPED and not g2.adj[mi, mj]:
                return False
        return True

    return ok(g_a, g_b, v_a, a_to_b) and ok(g_b, g_a, v_b, b_to_a)


def core_to_perm(core, num_atoms_a: int):
    a_to_b = {int(a): int(b) for a, b in core}
    return [a_to_b.get(a, UNMAPPED) for a in range(num_atoms_a)]


def perm_to_core(perm):
    core = sorted((a, b) for a, b in enumerate(perm) if b != UNMAPPED)
    return np.array(core)


def mcs(
    n_a: int,
    n_b: int,
    priority_idxs,
    bonds_a,
    bonds_b,
    max_visits: int,
    max_cores,
    enforce_core_core: bool,
    max_connected_components: Optional[int],
    min_connected_component_size: int,
    min_num_edges: int,
    initial_mapping,
    filter_fxn: Callable = lambda _: True,
    leaf_filter_fxn: Callable = lambda _: True,
):
    """Best-first McGregor MCS (ref mcgregor.py:436-564). Returns
    (all_cores, all_marcs, diagnostics)."""
    assert n_a <= n_b
    assert max_connected_components is None or max_connected_components > 0

    predicate = np.zeros((n_a, n_b), dtype=bool)
    for i, jdxs in enumerate(priority_idxs):
        for j in jdxs:
            predicate[i, j] = True

    g_a = _Graph(n_a, bonds_a)
    g_b = _Graph(n_b, bonds_b)

    marcs0 = _initial_marcs(g_a, g_b, predicate)
    root = _Node(tuple([UNMAPPED] * n_a), tuple([UNMAPPED] * n_b), marcs0, 0)

    if initial_mapping is not None and len(initial_mapping):
        init_kv = {int(a): int(b) for a, b in initial_mapping}
        for a in range(len(initial_mapping)):
            b = init_kv.get(a, UNMAPPED)
            a_to_b = list(root.a_to_b)
            b_to_a = list(root.b_to_a)
            a_to_b[root.layer] = b
            if b != UNMAPPED:
                b_to_a[b] = root.layer
            root = _Node(tuple(a_to_b), tuple(b_to_a), _refine_marcs(root.marcs, g_a, g_b, root.layer, b), root.layer + 1)

    if root.bound == 0:
        raise NoMappingError("No possible mapping given the predicate matrix")

    priority_idxs = tuple(tuple(x) for x in priority_idxs)

    def cc_ok(node: _Node) -> bool:
        if max_connected_components is None and min_connected_component_size <= 1:
            return True
        mapped_a = {a for a, b in enumerate(node.a_to_b[: node.layer]) if b != UNMAPPED}
        if mapped_a:
            unvisited_a = set(range(node.layer, n_a))
            if g_a.cc_constraints_violated(mapped_a, unvisited_a, max_connected_components, min_connected_component_size):
                return False
        mapped_b = {b for b, a in enumerate(node.b_to_a) if a != UNMAPPED}
        if mapped_b:
            unvisited_b = {b for bs in priority_idxs[node.layer :] for b in bs if b not in mapped_b}
            if g_b.cc_constraints_violated(mapped_b, unvisited_b, max_connected_components, min_connected_component_size):
                return False
        return True

    # best-first search
    queue = [root]
    best_num_edges = min_num_edges
    all_maps: list = []
    all_marcs: list = []
    nodes_visited = 0
    leaves_visited = 0
    timed_out = False
    last_node = None
    leaf_filter_cache: dict = {}

    def cached_leaf_filter(a_to_b):
        if a_to_b not in leaf_filter_cache:
            leaf_filter_cache[a_to_b] = leaf_filter_fxn(a_to_b)
        return leaf_filter_cache[a_to_b]

    while queue:
        node = heapq.heappop(queue)
        nodes_visited += 1
        last_node = node
        is_leaf = node.layer == n_a

        if is_leaf and any(b != UNMAPPED for b in node.a_to_b):
            if cached_leaf_filter(node.a_to_b):
                all_maps.append(node.a_to_b)
                all_marcs.append(node.marcs)
            leaves_visited += 1
            if leaves_visited == max_cores:
                timed_out = True
                break
        elif not is_leaf and node.bound >= best_num_edges:
            # expand
            children = []
            v_a = node.layer
            for v_b in priority_idxs[v_a]:
                if node.b_to_a[v_b] != UNMAPPED:
                    continue
                a_to_b = list(node.a_to_b)
                b_to_a = list(node.b_to_a)
                a_to_b[v_a] = v_b
                b_to_a[v_b] = v_a
                if enforce_core_core and not _core_preserves_edges(g_a, g_b, v_a, v_b, a_to_b, b_to_a):
                    continue
                child = _Node(tuple(a_to_b), tuple(b_to_a), _refine_marcs(node.marcs, g_a, g_b, v_a, v_b), v_a + 1)
                children.append(child)
            children.append(_Node(node.a_to_b, node.b_to_a, _refine_marcs(node.marcs, g_a, g_b, v_a, UNMAPPED), v_a + 1))

            for child in children:
                if child.bound < best_num_edges:
                    continue
                if not cc_ok(child):
                    continue
                if not filter_fxn(child.a_to_b):
                    continue
                if child.layer == n_a and cached_leaf_filter(child.a_to_b):
                    best_num_edges = max(best_num_edges, child.bound)
                heapq.heappush(queue, child)

        if nodes_visited == max_visits:
            timed_out = True
            break

    assert last_node is not None, "found no valid mappings"

    if len(all_maps) > 0:
        if timed_out and len(all_maps) < max_cores:
            warnings.warn(
                f"Inexhaustive search: reached max number of visits ({max_visits}) and found only "
                f"{len(all_maps)} out of {max_cores} desired cores.",
                MaxVisitsWarning,
            )
    elif timed_out:
        raise NoMappingError(
            f"Exceeded max number of visits/cores - no valid cores could be found: {nodes_visited} nodes visited."
        )

    if len(all_maps) == 0:
        raise NoMappingError(f"Unable to find mapping with at least {min_num_edges} edges")

    all_cores = [perm_to_core(a_to_b) for a_to_b in all_maps]

    return (
        all_cores,
        all_marcs,
        MCSDiagnostics(
            total_nodes_visited=nodes_visited,
            total_leaves_visited=leaves_visited,
            core_size=len(all_cores[0]),
            num_cores=len(all_cores),
        ),
    )
