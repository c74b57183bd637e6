"""Greedy λ-protocol bisection (the port of
timemachine_tpu/fe/protocol_refinement.py)."""

from __future__ import annotations

from typing import Callable


def copy_and_insert(xs: list, idx: int, x) -> list:
    assert idx <= len(xs)
    out = xs.copy()
    out.insert(idx, x)
    return out


def greedy_bisection_step(protocol: list, local_cost: Callable, make_intermediate: Callable):
    """Insert a new state at the midpoint of the adjacent pair with the
    largest cost (ref protocol_refinement.py:6-42). Returns (refined
    protocol, (costs, left_idx, new_state))."""
    assert len(protocol) >= 2
    pairs = list(zip(protocol, protocol[1:]))
    costs = [local_cost(left, right) for left, right in pairs]
    pairs_by_cost = [(cost, left_idx, pair) for left_idx, (pair, cost) in enumerate(zip(pairs, costs))]
    _, left_idx, (left, right) = max(pairs_by_cost)
    new_state = make_intermediate(left, right)
    refined = copy_and_insert(protocol, left_idx + 1, new_state)
    return refined, (costs, left_idx, new_state)
