"""Dummy-group factorization for alchemical end states.

Parity target: reference timemachine/fe/dummy.py. Dummy atoms must couple to
the core only through a single bond-anchor atom per group so the end-state
partition functions factorize and cancel (the core invariant of
single-topology RBFE).

The port's copy of timemachine_tpu/fe/dummy.py: the bond graphs are
graph_utils.Graph, whose components and subgraphs iterate as networkx's, so
the groups, their anchors and the first assignment come out alike."""

from __future__ import annotations

import warnings
from collections import defaultdict
from itertools import product
from typing import Optional

from timemachine_torch.graph_utils import Graph, connected_components


class MultipleAnchorWarning(UserWarning):
    pass


def canonicalize_bond(ixn: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(ixn[::-1]) if ixn[0] > ixn[-1] else tuple(ixn)


def translate_bonds(bonds, mapping: dict[int, int]):
    """Apply an atom-index mapping to bonds, dropping bonds with unmapped
    atoms (ref dummy.py:187-193)."""
    return [
        canonicalize_bond(tuple(mapping[idx] for idx in bond))
        for bond in bonds
        if all(idx in mapping for idx in bond)
    ]


def get_core_bonds(bonds_a, bonds_b, core_atoms_a, core_atoms_b) -> frozenset:
    """Core-core bonds present in both molecules (ref dummy.py:175-184)."""
    a_to_c = {a: c for c, a in enumerate(core_atoms_a)}
    b_to_c = {b: c for c, b in enumerate(core_atoms_b)}
    return frozenset(translate_bonds(bonds_a, a_to_c)) & frozenset(translate_bonds(bonds_b, b_to_c))


def union_by_key(ts) -> dict:
    d: defaultdict = defaultdict(frozenset)
    for k, xs in ts:
        d[k] = d[k] | xs
    return dict(d)


def generate_dummy_group_assignments(bond_graph: Graph, core_atoms):
    """Iterator over candidate partitionings of dummy atoms into anchored
    groups (ref dummy.py:14-89): connected components of the dummy-induced
    subgraph, each assigned one of its core bond-anchors; components sharing
    an anchor merge."""
    assert len(set(core_atoms)) == len(core_atoms)
    assert len(list(connected_components(bond_graph))) == 1

    core_set = frozenset(core_atoms)
    dummy_atoms = frozenset(bond_graph.nodes()) - core_set
    induced = bond_graph.subgraph(dummy_atoms)

    def get_bond_anchors(dummy_group):
        anchors = {n for d in dummy_group for n in bond_graph.neighbors(d) if n in core_set}
        if len(anchors) > 1:
            warnings.warn(f"Multiple bond anchors {anchors} found for dummy group: {dummy_group}", MultipleAnchorWarning)
        return anchors

    return (
        union_by_key(pairs)
        for pairs in product(
            *[[(anchor, frozenset(cc)) for anchor in get_bond_anchors(cc)] for cc in connected_components(induced)]
        )
    )


def generate_anchored_dummy_group_assignments(
    dummy_groups: dict[int, frozenset],
    bond_graph_a: Graph,
    bond_graph_b: Graph,
    core_atoms_a,
    core_atoms_b,
):
    """Iterator over (bond anchor -> (angle anchor | None, dummy group))
    assignments; the angle anchor must be a core neighbor of the bond anchor
    whose bond exists in BOTH molecules (ref dummy.py:92-165). Indices refer
    to atoms of B."""
    core_bonds_c = get_core_bonds(bond_graph_a.edges(), bond_graph_b.edges(), core_atoms_a, core_atoms_b)
    c_to_b = {c: b for c, b in enumerate(core_atoms_b)}
    core_bonds_b = frozenset(translate_bonds(core_bonds_c, c_to_b))
    core_set_b = set(core_atoms_b)

    def get_angle_anchors(bond_anchor):
        valid = [
            aa
            for aa in bond_graph_b.neighbors(bond_anchor)
            if aa in core_set_b and canonicalize_bond((bond_anchor, aa)) in core_bonds_b
        ]
        return valid or [None]

    return (
        dict(assignment)
        for assignment in product(
            *[
                [(bond_anchor, (angle_anchor, dg)) for angle_anchor in get_angle_anchors(bond_anchor)]
                for bond_anchor, dg in dummy_groups.items()
            ]
        )
    )
