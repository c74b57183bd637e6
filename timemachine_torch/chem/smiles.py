"""Minimal SMILES parser (the port's copy of timemachine_tpu/chem/smiles.py;
kekulization matches with graph_utils.max_cardinality_matching where the JAX
package calls networkx's max_weight_matching, so a ring with several Kekulé
structures may get another one, ROADMAP P17): enough to construct
test/benchmark molecules and residue templates natively (the reference constructs these with RDKit, e.g.
ff/handlers/utils.py:10-38 residue SMILES, testsystems).

Supports: organic subset + bracket atoms (isotope, symbol, chirality tag,
H-count, charge), branches, ring closures (incl. %nn), bond symbols
- = # : / \\, aromatic lowercase with kekulization, implicit-H filling by
default valence. Chirality tags are recorded but not interpreted (matching
ignores chirality, as the reference's match_smirks does by default).
"""

from __future__ import annotations

import numpy as np

from timemachine_torch.chem.mol import Atom, Bond, Mol
from timemachine_torch.chem.periodic import ATOMIC_NUM, DEFAULT_VALENCES
from timemachine_torch.graph_utils import Graph, max_cardinality_matching

ORGANIC_SUBSET = ["Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I"]
AROMATIC_ORGANIC = ["b", "c", "n", "o", "p", "s"]


class _ParsedAtom:
    __slots__ = ("z", "charge", "h_count", "aromatic", "chiral", "explicit_h")

    def __init__(self, z, charge=0, h_count=None, aromatic=False, chiral=None):
        self.z = z
        self.charge = charge
        self.h_count = h_count  # None = fill by valence
        self.aromatic = aromatic
        self.chiral = chiral


def _parse_bracket(s: str, pos: int) -> tuple[_ParsedAtom, int]:
    end = s.index("]", pos)
    body = s[pos + 1 : end]
    i = 0
    while i < len(body) and body[i].isdigit():  # isotope, ignored
        i += 1
    # symbol (possibly aromatic lowercase)
    aromatic = False
    if body[i : i + 2] in ATOMIC_NUM and body[i : i + 2] not in ("Sc",):  # two-letter first
        sym = body[i : i + 2]
        i += 2
    elif body[i].islower() and body[i].upper() in ATOMIC_NUM:
        sym = body[i].upper()
        aromatic = True
        i += 1
    elif body[i : i + 1] in ATOMIC_NUM:
        sym = body[i]
        i += 1
    elif body[i : i + 2].capitalize() in ATOMIC_NUM:
        sym = body[i : i + 2].capitalize()
        aromatic = body[i].islower()
        i += 2
    else:
        raise ValueError(f"cannot parse atom symbol in [{body}]")
    chiral = None
    if body[i : i + 2] == "@@":
        chiral = "@@"
        i += 2
    elif body[i : i + 1] == "@":
        chiral = "@"
        i += 1
    h_count = 0
    if i < len(body) and body[i] == "H":
        i += 1
        num = ""
        while i < len(body) and body[i].isdigit():
            num += body[i]
            i += 1
        h_count = int(num) if num else 1
    charge = 0
    while i < len(body) and body[i] in "+-":
        sign = 1 if body[i] == "+" else -1
        i += 1
        num = ""
        while i < len(body) and body[i].isdigit():
            num += body[i]
            i += 1
        charge += sign * (int(num) if num else 1)
    return _ParsedAtom(ATOMIC_NUM[sym], charge, h_count, aromatic, chiral), end + 1


def _fill_implicit_h(atom: _ParsedAtom, bond_order_sum: float) -> int:
    if atom.h_count is not None:
        return atom.h_count
    valences = DEFAULT_VALENCES.get(atom.z)
    if valences is None:
        return 0
    # charge adjustment for common cases (N+ -> 4, O- -> 1, etc.)
    adjust = atom.charge if atom.z in (5, 7, 15) else -atom.charge if atom.z in (8, 16, 9, 17, 35, 53) else atom.charge
    if atom.z == 6:
        adjust = -abs(atom.charge)
    for v in valences:
        target = v + adjust
        if bond_order_sum <= target:
            return int(round(target - bond_order_sum))
    return 0


def _kekulize(atoms: list[_ParsedAtom], bonds: list[list], aromatic_bond_idxs: set[int], degree: list[int]):
    """Assign alternating single/double orders to aromatic bonds via perfect
    matching over atoms that need one in-ring double bond."""
    needs_double = {}
    for idx, a in enumerate(atoms):
        if not a.aromatic:
            continue
        if a.z == 6:
            needs_double[idx] = a.charge == 0
        elif a.z == 7 or a.z == 15:
            has_h = (a.h_count or 0) > 0
            # pyrrole-type (3 connections or NH or anion) donates lone pair
            needs_double[idx] = not (has_h or degree[idx] + (a.h_count or 0) == 3 or a.charge == -1)
        elif a.z in (8, 16):
            needs_double[idx] = a.charge == 1  # o+/s+ need a double bond
        elif a.z == 5:
            needs_double[idx] = False
        else:
            needs_double[idx] = False

    # account for exocyclic double bonds already present
    for i, j, order, _ in bonds:
        if order == 2:
            for k in (i, j):
                if k in needs_double:
                    needs_double[k] = False

    g = Graph()
    bond_of = {}
    active = {i for i, need in needs_double.items() if need}
    for bi in aromatic_bond_idxs:
        i, j, _, _ = bonds[bi]
        if i in active and j in active:
            g.add_edge(i, j)
            bond_of[(i, j)] = bond_of[(j, i)] = bi
    matching = max_cardinality_matching(g)
    matched_atoms = set()
    for i, j in matching:
        bi = bond_of[(i, j)]
        bonds[bi][2] = 2
        matched_atoms.update((i, j))
    unmatched = active - matched_atoms
    if unmatched:
        raise ValueError(f"kekulization failed: unmatched aromatic atoms {sorted(unmatched)}")


def mol_from_smiles(smiles: str, add_hs: bool = False, name: str = "") -> Mol:
    atoms: list[_ParsedAtom] = []
    bonds: list[list] = []  # [i, j, order, aromatic_flag]
    ring_closures: dict[str, tuple[int, int | None]] = {}
    stack: list[int] = []
    prev: int | None = None
    pending_bond: int | None = None
    pending_aromatic_bond = False

    i = 0
    s = smiles
    while i < len(s):
        c = s[i]
        if c == "(":
            stack.append(prev)
            i += 1
            continue
        if c == ")":
            prev = stack.pop()
            i += 1
            continue
        if c in "-=#:/\\":
            pending_bond = {"-": 1, "=": 2, "#": 3, ":": 4, "/": 1, "\\": 1}[c]
            pending_aromatic_bond = c == ":"
            i += 1
            continue
        if c.isdigit() or c == "%":
            if c == "%":
                label = s[i + 1 : i + 3]
                i += 3
            else:
                label = c
                i += 1
            if label in ring_closures:
                j, bond_order = ring_closures.pop(label)
                order = pending_bond or bond_order or (4 if (atoms[prev].aromatic and atoms[j].aromatic) else 1)
                bonds.append([j, prev, order, order == 4])
            else:
                ring_closures[label] = (prev, pending_bond)
            pending_bond = None
            pending_aromatic_bond = False
            continue

        # atom token
        if c == "[":
            atom, i = _parse_bracket(s, i)
        elif s[i : i + 2] in ORGANIC_SUBSET:
            atom = _ParsedAtom(ATOMIC_NUM[s[i : i + 2]])
            i += 2
        elif c in ORGANIC_SUBSET:
            atom = _ParsedAtom(ATOMIC_NUM[c])
            i += 1
        elif c in AROMATIC_ORGANIC:
            atom = _ParsedAtom(ATOMIC_NUM[c.upper()], aromatic=True)
            i += 1
        else:
            raise ValueError(f"unexpected character {c!r} at {i} in {smiles!r}")

        atoms.append(atom)
        idx = len(atoms) - 1
        if prev is not None:
            if pending_bond is not None:
                order = pending_bond
                aroma = pending_aromatic_bond
            elif atoms[prev].aromatic and atom.aromatic:
                order = 4
                aroma = True
            else:
                order = 1
                aroma = False
            bonds.append([prev, idx, order, aroma])
        prev = idx
        pending_bond = None
        pending_aromatic_bond = False

    if ring_closures:
        raise ValueError(f"unclosed ring bonds: {sorted(ring_closures)} in {smiles!r}")

    degree = [0] * len(atoms)
    for b in bonds:
        degree[b[0]] += 1
        degree[b[1]] += 1

    aromatic_bond_idxs = {k for k, b in enumerate(bonds) if b[3] or (atoms[b[0]].aromatic and atoms[b[1]].aromatic and b[2] == 4)}
    # mark default aromatic-aromatic bonds written as order 4
    if any(a.aromatic for a in atoms):
        _kekulize(atoms, bonds, aromatic_bond_idxs, degree)
        for bi in aromatic_bond_idxs:
            if bonds[bi][2] == 4:
                bonds[bi][2] = 1

    # implicit hydrogens
    order_sum = [0.0] * len(atoms)
    for i0, j0, order, _ in bonds:
        order_sum[i0] += order
        order_sum[j0] += order
    mol_atoms = []
    for k, a in enumerate(atoms):
        nh = _fill_implicit_h(a, order_sum[k])
        mol_atoms.append(Atom(a.z, a.charge, implicit_h=nh))

    mol = Mol(mol_atoms, [Bond(b[0], b[1], b[2]) for b in bonds], name=name)
    if add_hs:
        mol = mol.add_hydrogens()
    return mol
