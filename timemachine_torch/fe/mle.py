"""Absolute free energies per node from a graph of relative (edge)
estimates (the port of timemachine_tpu/fe/mle.py; DiffNet, Xu 2019,
doi:10.1021/acs.jcim.9b00528).

For Gaussian edge likelihoods the maximum-likelihood node values solve the
weighted graph's normal equations L x = A^T W d, L = A^T W A, in closed form:
one pseudo-inverse of L serves the point estimate and every bootstrap
replicate. The arithmetic is numpy's, as in JAX's, and so are the
bootstrap draws (np.random.default_rng(seed)); the connectivity check runs
on the port's graph_utils. The graph front end reads any graph object with
networkx's surface (`edges(data=True)`, `nodes`, `nodes[n]`, `add_node`,
`add_edge`) and imports no networkx (ROADMAP P34).
"""

from __future__ import annotations

import numpy as np

from timemachine_torch.graph_utils import Graph, connected_components, graph_from_bonds

# the graph type the front end reads: the port's Graph, or any object with
# nodes(), edges() and subscripted edge data (a networkx DiGraph included)
NxDiGraph = Graph

MIN_EDGE_STDDEV = 1e-3


def _edge_arrays(edge_idxs, edge_diffs, edge_stddevs):
    edge_idxs = np.asarray(edge_idxs, dtype=int)
    edge_diffs = np.asarray(edge_diffs, dtype=float)
    stddevs = np.maximum(np.asarray(edge_stddevs, dtype=float), MIN_EDGE_STDDEV)
    if not (len(edge_idxs) == len(edge_diffs) == len(stddevs)):
        raise ValueError("edge_idxs, edge_diffs, edge_stddevs must have equal length")
    return edge_idxs, edge_diffs, stddevs


def _validate_graph(edge_idxs) -> int:
    """Every node 0..K-1 appears and the graph is one connected component."""
    n_nodes = int(edge_idxs.max()) + 1
    present = np.zeros(n_nodes, dtype=bool)
    present[edge_idxs.reshape(-1)] = True
    if not present.all():
        raise ValueError(f"nodes {np.flatnonzero(~present).tolist()} have no edges")

    reachable = next(connected_components(graph_from_bonds(n_nodes, edge_idxs)))
    if len(reachable) != n_nodes:
        raise ValueError("edge graph is not connected")
    return n_nodes


def _laplacian_pinv_and_projector(edge_idxs, stddevs, n_nodes):
    """Pseudo-inverse of the weighted Laplacian plus the weighted incidence
    operator Aᵀ W, so node solutions are x = L⁺ (Aᵀ W) d for any d."""
    src, dst = edge_idxs.T
    w = 1.0 / stddevs**2

    # incidence: row e has -1 at src(e), +1 at dst(e)
    n_edges = len(src)
    A = np.zeros((n_edges, n_nodes))
    A[np.arange(n_edges), src] = -1.0
    A[np.arange(n_edges), dst] = 1.0

    AtW = A.T * w  # (n_nodes, n_edges)
    L = AtW @ A
    return np.linalg.pinv(L, hermitian=True), AtW


def _anchor(x, ref_node_idxs, ref_node_vals):
    """Shift the gauge so the mean residual at the reference nodes vanishes.
    x may be (K,) or (B, K); broadcasting handles both."""
    ref_node_idxs = np.asarray(ref_node_idxs, dtype=int)
    ref_node_vals = np.asarray(ref_node_vals, dtype=float)
    offset = np.mean(ref_node_vals - x[..., ref_node_idxs], axis=-1, keepdims=True)
    return x + offset


def _default_refs(ref_node_idxs, ref_node_vals, with_stddevs=False):
    if len(ref_node_idxs) == 0:
        print("no reference node values: picking node 0 as arbitrary reference")
        if with_stddevs:
            return [0], [0.0], [0.0]
        return [0], [0.0]
    if with_stddevs:
        return ref_node_idxs, ref_node_vals, None
    return ref_node_idxs, ref_node_vals


def infer_node_vals(edge_idxs, edge_diffs, edge_stddevs, ref_node_idxs=tuple(), ref_node_vals=tuple()):
    """ML node values given Gaussian edge differences; the free additive
    constant is fixed by averaging over the reference nodes."""
    edge_idxs, edge_diffs, stddevs = _edge_arrays(edge_idxs, edge_diffs, edge_stddevs)
    n_nodes = _validate_graph(edge_idxs)
    ref_node_idxs, ref_node_vals = _default_refs(ref_node_idxs, ref_node_vals)
    assert len(ref_node_idxs) == len(ref_node_vals), "ref idxs/vals length mismatch"

    L_pinv, AtW = _laplacian_pinv_and_projector(edge_idxs, stddevs, n_nodes)
    x = L_pinv @ (AtW @ edge_diffs)
    return _anchor(x, ref_node_idxs, ref_node_vals)


def infer_node_vals_and_errs(
    edge_idxs,
    edge_diffs,
    edge_stddevs,
    ref_node_idxs=tuple(),
    ref_node_vals=tuple(),
    ref_node_stddevs=tuple(),
    n_bootstrap=100,
    seed=0,
):
    """(node values, bootstrap stddevs). Each bootstrap replicate perturbs
    edge diffs and reference values by their claimed stddevs; all replicates
    share one Laplacian pseudo-inverse (vectorized solve)."""
    edge_idxs, edge_diffs, stddevs = _edge_arrays(edge_idxs, edge_diffs, edge_stddevs)
    n_nodes = _validate_graph(edge_idxs)

    refs = _default_refs(ref_node_idxs, ref_node_vals, with_stddevs=True)
    if refs[2] is not None:
        ref_node_idxs, ref_node_vals, ref_node_stddevs = refs
    else:
        ref_node_idxs, ref_node_vals = refs[0], refs[1]
    ref_node_idxs = np.asarray(ref_node_idxs, dtype=int)
    ref_node_vals = np.asarray(ref_node_vals, dtype=float)
    ref_node_stddevs = np.asarray(ref_node_stddevs, dtype=float)
    assert len(ref_node_idxs) == len(ref_node_vals) == len(ref_node_stddevs), "ref arrays length mismatch"

    L_pinv, AtW = _laplacian_pinv_and_projector(edge_idxs, stddevs, n_nodes)
    solve = lambda d: (L_pinv @ (AtW @ d.T)).T  # d: (..., n_edges) -> (..., n_nodes)

    point = _anchor(solve(edge_diffs), ref_node_idxs, ref_node_vals)

    rng = np.random.default_rng(seed)
    noisy_d = edge_diffs + rng.standard_normal((n_bootstrap, len(edge_diffs))) * stddevs
    noisy_refs = ref_node_vals + rng.standard_normal((n_bootstrap, len(ref_node_vals))) * ref_node_stddevs
    replicates = solve(noisy_d)  # (n_bootstrap, n_nodes)
    offsets = np.mean(noisy_refs - replicates[:, ref_node_idxs], axis=1, keepdims=True)
    return point, (replicates + offsets).std(axis=0)


def infer_node_vals_and_errs_networkx(
    graph,
    edge_diff_prop: str,
    edge_stddev_prop: str,
    ref_node_val_prop: str,
    ref_node_stddev_prop: str,
    node_val_prop: str = "inferred_dg",
    node_stddev_prop: str = "inferred_dg_stddev",
    edge_skip_prop: str = "skip_for_mle",
    n_bootstrap: int = 100,
    seed: int = 0,
):
    """The graph front end: run the inference on the largest usable
    connected component of a directed graph (networkx's DiGraph or
    MultiDiGraph surface) and return a new graph of the same class holding
    that component, its nodes annotated with values and stddevs.

    Edges are taken in the graph's order; networkx's subgraph views keep it
    too, but where a component holds fewer than half of the graph's nodes
    they iterate a set of them instead, and the bootstrap's draws may then
    fall on the edges in another order."""
    if not graph.is_directed():
        raise TypeError("graph must be a DiGraph or MultiDiGraph")

    usable = [
        (u, v, d)
        for u, v, d in graph.edges(data=True)
        if d.get(edge_diff_prop) is not None and d.get(edge_stddev_prop) is not None and d.get(edge_skip_prop) is not True
    ]
    if not usable:
        raise ValueError("Empty graph after removing edges without predictions")
    touched = {n for u, v, _ in usable for n in (u, v)}
    undirected = Graph()
    undirected.add_nodes_from(n for n in graph.nodes if n in touched)
    undirected.add_edges_from((u, v) for u, v, _ in usable)

    def component_rank(component):
        n_refs = sum(graph.nodes[n].get(ref_node_val_prop) is not None for n in component)
        return (len(component), n_refs, max(component))

    best = max(connected_components(undirected), key=component_rank)
    edges = [(u, v, d) for u, v, d in usable if u in best]

    ordered_nodes = sorted(best)
    index_of = {n: i for i, n in enumerate(ordered_nodes)}
    edge_idxs = np.array([(index_of[u], index_of[v]) for u, v, _ in edges])
    diffs = np.array([d[edge_diff_prop] for _, _, d in edges])
    errs = np.array([d[edge_stddev_prop] for _, _, d in edges])

    ref_idxs, ref_vals, ref_errs = [], [], []
    for n in ordered_nodes:
        data = graph.nodes[n]
        if ref_node_val_prop in data:
            ref_idxs.append(index_of[n])
            ref_vals.append(data[ref_node_val_prop])
            ref_errs.append(data.get(ref_node_stddev_prop, 0.0))

    vals, stddevs = infer_node_vals_and_errs(
        edge_idxs, diffs, errs, ref_idxs, ref_vals, ref_errs, n_bootstrap=n_bootstrap, seed=seed
    )

    annotated = type(graph)()
    for n in (n for n in graph.nodes if n in best):
        data = dict(graph.nodes[n])
        data[node_val_prop] = vals[index_of[n]]
        data[node_stddev_prop] = stddevs[index_of[n]]
        annotated.add_node(n, **data)
    for u, v, d in edges:
        annotated.add_edge(u, v, **dict(d))
    return annotated
