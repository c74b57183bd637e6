"""Bond-graph helpers: the graph algorithms that the JAX package's builders
take from networkx, written here because the port does not use networkx.

`Graph` is an undirected graph over dict-of-dict adjacency, as networkx
keeps it: nodes iterate in insertion order, each node's neighbours in the
order their edges were added, and `edges()` and `subgraph()` follow
networkx's orders. The traversals below reproduce networkx's visiting
orders where the JAX package keeps them (the exclusion list is built in
`all_pairs_shortest_path_length`'s order, dummy groups in
`connected_components`'); `minimum_cycle_basis` and `bridges` give the
same sets. `max_cardinality_matching` is Edmonds' blossom search, which may
pick another perfect matching than networkx's `max_weight_matching`.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Sequence


class Graph:
    """Undirected simple graph (the subset of networkx.Graph the builders use)."""

    def __init__(self):
        self._adj: dict = {}

    def add_node(self, n):
        self._adj.setdefault(n, {})

    def add_nodes_from(self, nodes: Iterable):
        for n in nodes:
            self.add_node(n)

    def add_edge(self, u, v):
        self.add_node(u)
        self.add_node(v)
        self._adj[u][v] = True
        self._adj[v][u] = True

    def add_edges_from(self, edges: Iterable):
        for u, v in edges:
            self.add_edge(u, v)

    def nodes(self) -> list:
        return list(self._adj)

    def neighbors(self, n) -> Iterator:
        return iter(self._adj[n])

    def has_edge(self, u, v) -> bool:
        return u in self._adj and v in self._adj[u]

    def edges(self) -> list:
        """Each edge once, as networkx's EdgeView iterates: (n, nbr) for
        nodes n in order, nbr not yet seen as an n."""
        seen = set()
        out = []
        for n, nbrs in self._adj.items():
            out.extend((n, nbr) for nbr in nbrs if nbr not in seen)
            seen.add(n)
        return out

    def subgraph(self, nodes: Iterable) -> "Graph":
        """The induced subgraph. Nodes iterate as networkx's subgraph view
        iterates them: in the order of set(nodes) when they are fewer than
        half of this graph's, else in this graph's order; neighbours in this
        graph's order."""
        keep = set(n for n in nodes if n in self._adj)
        order = keep if 2 * len(keep) < len(self._adj) else [n for n in self._adj if n in keep]
        g = Graph()
        g._adj = {n: {m: True for m in self._adj[n] if m in keep} for n in order}
        return g

    def __iter__(self):
        return iter(self._adj)

    def __len__(self):
        return len(self._adj)


def graph_from_bonds(num_atoms: int, bonds: Iterable[Sequence[int]]) -> Graph:
    """Nodes 0..num_atoms-1, then the bonds in order."""
    g = Graph()
    g.add_nodes_from(range(num_atoms))
    g.add_edges_from((int(i), int(j)) for i, j in bonds)
    return g


def _plain_bfs(g: Graph, n: int, source) -> set:
    # the insertion order of `seen` is networkx's, so the set iterates alike
    adj = g._adj
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def connected_components(g: Graph) -> Iterator[set]:
    """Components as sets, in the order of their first node (networkx's)."""
    seen: set = set()
    n = len(g)
    for v in g:
        if v not in seen:
            c = _plain_bfs(g, n - len(seen), v)
            seen.update(c)
            yield c


def single_source_shortest_path_length(g: Graph, source, cutoff=None) -> dict:
    """{node: bond distance} in BFS order: each level's nodes in the order
    the previous level's nodes reach them through their neighbour lists."""
    adj = g._adj
    out = {source: 0}
    nextlevel = [source]
    level = 0
    n = len(adj)
    while nextlevel and (cutoff is None or cutoff > level):
        level += 1
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in out:
                    out[w] = level
                    nextlevel.append(w)
            if len(out) == n:
                return out
    return out


def all_pairs_shortest_path_length(g: Graph, cutoff=None) -> Iterator[tuple]:
    for n in g:
        yield n, single_source_shortest_path_length(g, n, cutoff)


def bridges(g: Graph) -> set:
    """Edges whose removal disconnects their component, as sorted tuples."""
    disc: dict = {}
    low: dict = {}
    out = set()
    counter = 0
    for root in g:
        if root in disc:
            continue
        disc[root] = low[root] = counter
        counter += 1
        stack = [(root, None, iter(g._adj[root]))]
        while stack:
            v, parent, it = stack[-1]
            advanced = False
            for w in it:
                if w == parent:
                    continue
                if w in disc:
                    low[v] = min(low[v], disc[w])
                else:
                    disc[w] = low[w] = counter
                    counter += 1
                    stack.append((w, v, iter(g._adj[w])))
                    advanced = True
                    break
            if not advanced:
                stack.pop()
                if parent is not None:
                    low[parent] = min(low[parent], low[v])
                    if low[v] > disc[parent]:
                        out.add(tuple(sorted((parent, v))))
    return out


def _bfs_tree(g: Graph, root) -> dict:
    prev = {root: None}
    q = deque([root])
    while q:
        v = q.popleft()
        for w in g._adj[v]:
            if w not in prev:
                prev[w] = v
                q.append(w)
    return prev


def _tree_path(prev: dict, v) -> list:
    path = [v]
    while prev[path[-1]] is not None:
        path.append(prev[path[-1]])
    return path[::-1]


def minimum_cycle_basis(g: Graph) -> list:
    """A minimum cycle basis (Horton's candidates, kept greedily by length
    where independent over GF(2)), each cycle as its nodes in cycle order."""
    edges = [tuple(sorted(e)) for e in g.edges()]
    edge_bit = {e: 1 << k for k, e in enumerate(edges)}
    n_components = sum(1 for _ in connected_components(g))
    rank = len(edges) - len(g) + n_components
    if rank == 0:
        return []
    candidates = {}
    for v in g:
        prev = _bfs_tree(g, v)
        for x, y in edges:
            if x not in prev:
                continue
            cycle = _tree_path(prev, x) + _tree_path(prev, y)[:0:-1]
            if len(set(cycle)) != len(cycle) or len(cycle) < 3:
                continue
            bits = 0
            for k in range(len(cycle)):
                bits ^= edge_bit[tuple(sorted((cycle[k], cycle[(k + 1) % len(cycle)])))]
            candidates.setdefault(bits, cycle)
    basis_rows: dict = {}  # pivot bit -> reduced row
    out = []
    for bits, cycle in sorted(candidates.items(), key=lambda kv: (len(kv[1]), sorted(kv[1]))):
        r = bits
        while r:
            pivot = r & -r
            if pivot not in basis_rows:
                break
            r ^= basis_rows[pivot]
        if r:
            basis_rows[r & -r] = r
            out.append(cycle)
            if len(out) == rank:
                break
    return out


def max_cardinality_matching(g: Graph) -> set:
    """A maximum-cardinality matching (Edmonds' blossom search from each
    free node in node order), as a set of (u, v) edges."""
    nodes = list(g)
    index = {v: k for k, v in enumerate(nodes)}
    adj = [[index[w] for w in g._adj[v]] for v in nodes]
    n = len(nodes)
    match = [-1] * n

    def find_path(root):
        parent = [-1] * n
        base = list(range(n))
        used = [False] * n
        used[root] = True
        q = deque([root])

        def lca(a, b):
            seen = [False] * n
            while True:
                a = base[a]
                seen[a] = True
                if match[a] == -1:
                    break
                a = parent[match[a]]
            while True:
                b = base[b]
                if seen[b]:
                    return b
                b = parent[match[b]]

        def mark_path(v, b, child, blossom):
            while base[v] != b:
                blossom[base[v]] = blossom[base[match[v]]] = True
                parent[v] = child
                child = match[v]
                v = parent[match[v]]

        while q:
            v = q.popleft()
            for to in adj[v]:
                if base[v] == base[to] or match[v] == to:
                    continue
                if to == root or (match[to] != -1 and parent[match[to]] != -1):
                    cur = lca(v, to)
                    blossom = [False] * n
                    mark_path(v, cur, to, blossom)
                    mark_path(to, cur, v, blossom)
                    for i in range(n):
                        if blossom[base[i]]:
                            base[i] = cur
                            if not used[i]:
                                used[i] = True
                                q.append(i)
                elif parent[to] == -1:
                    parent[to] = v
                    if match[to] == -1:
                        return to, parent
                    used[match[to]] = True
                    q.append(match[to])
        return -1, parent

    for root in range(n):
        if match[root] != -1:
            continue
        end, parent = find_path(root)
        while end != -1:
            pv = parent[end]
            ppv = match[pv]
            match[end], match[pv] = pv, end
            end = ppv
    return {(nodes[i], nodes[j]) for i, j in enumerate(match) if j > i}


# Adjacency-list helpers (the JAX package's own graph_utils API)


def mol_adjacency(mol) -> list[list[int]]:
    """Adjacency list of a chem.Mol's bond graph, indexed by atom index."""
    adj: list[list[int]] = [[] for _ in range(mol.num_atoms)]
    for b in mol.bonds:
        adj[b.src].append(b.dst)
        adj[b.dst].append(b.src)
    return adj


def adjacency_from_bonds(n_nodes: int, bond_idxs: Iterable[Sequence[int]]) -> list[list[int]]:
    """Adjacency list from an iterable of (src, dst) edges."""
    adj: list[list[int]] = [[] for _ in range(n_nodes)]
    for i, j in bond_idxs:
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    return adj


def simple_paths_from(adj: Sequence[Sequence[int]], start: int, n_nodes: int) -> list[tuple[int, ...]]:
    """Simple (no repeated node) paths of exactly `n_nodes` nodes starting at
    `start`, via an explicit DFS stack."""
    found: list[tuple[int, ...]] = []
    stack: list[tuple[int, ...]] = [(start,)]
    while stack:
        path = stack.pop()
        if len(path) == n_nodes:
            found.append(path)
            continue
        tail = path[-1]
        for nb in adj[tail]:
            if nb not in path:
                stack.append(path + (nb,))
    return found


def simple_paths(adj: Sequence[Sequence[int]], n_nodes: int) -> list[tuple[int, ...]]:
    """All simple paths of exactly `n_nodes` nodes, from every start node."""
    out: list[tuple[int, ...]] = []
    for start in range(len(adj)):
        out.extend(simple_paths_from(adj, start, n_nodes))
    return out


def connected_component(adj: Sequence[Sequence[int]], seed: int) -> set[int]:
    """Nodes reachable from `seed` (BFS)."""
    seen = {seed}
    frontier = [seed]
    while frontier:
        nxt = []
        for node in frontier:
            for nb in adj[node]:
                if nb not in seen:
                    seen.add(nb)
                    nxt.append(nb)
        frontier = nxt
    return seen
