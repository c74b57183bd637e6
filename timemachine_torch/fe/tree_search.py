"""Best-first search over a lazily expanded tree (the port of
timemachine_tpu/fe/tree_search.py). Used by greedy schedule/refinement searches;
kept API-compatible with the reference's generator contract."""

import heapq
from typing import Callable, Iterator, Optional, Sequence, TypeVar

Node = TypeVar("Node")
State = TypeVar("State")


def best_first(
    expand: Callable[[Node, State], tuple[Sequence[Node], State]],
    root: Node,
    initial_state: State,
    key: Optional[Callable[[Node], object]] = None,
) -> Iterator[Node]:
    """Yield nodes in priority order, expanding each yielded node's children
    into the frontier (ref tree_search.py:9-38).

    `expand` maps (node, search_state) -> (children, updated_state);
    stateless searches may ignore and pass through the state. `key`
    optionally supplies the ordering (insertion order breaks ties), so nodes
    themselves need not be comparable; by default the nodes' own `<` is used,
    matching the reference.
    """
    prio = key if key is not None else (lambda n: n)
    state = initial_state
    frontier: list = []
    stamp = 0  # FIFO tie-break; also shields heapq from incomparable payloads under `key`

    def push(node):
        nonlocal stamp
        entry = (prio(node), stamp, node) if key is not None else node
        heapq.heappush(frontier, entry)
        stamp += 1

    push(root)
    while frontier:
        entry = heapq.heappop(frontier)
        node = entry[2] if key is not None else entry
        children, state = expand(node, state)
        yield node
        for child in children:
            push(child)
