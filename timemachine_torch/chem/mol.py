"""Molecular graph with ring perception and aromaticity models (the port's
copy of timemachine_tpu/chem/mol.py, its networkx calls on the port's
graph_utils: `to_nx` gives a graph_utils.Graph, and the rings are a minimum
cycle basis, each in cycle order).

Native replacement for the slice of RDKit the reference uses: molecule
objects with conformers and properties (ref `timemachine/fe/utils.py`
get_romol_conf/set_romol_conf), ring info, and the two aromaticity models the
forcefield handlers rely on:

* "mdl"    — benzene-like perception used for SMIRKS valence/LJ assignment
             (ref ff/handlers/utils.py:84-85 uses RDKit AROMATICITY_MDL:
             6-membered C/N rings with alternating bonds)
* "am1bcc" — the Jakalian-Jack-Bayly AM1BCC aromaticity algorithm used by
             the charge-correction handlers (ref ff/handlers/
             bcc_aromaticity.py, cases 1-5), implemented over our SMARTS
             engine in chem/aromaticity.py.

Coordinates are stored in Å (SDF-native); `get_conf()` returns nm (the
engine's unit), mirroring the reference's get_romol_conf (fe/utils.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from timemachine_torch.chem.periodic import ATOMIC_NUM, DEFAULT_VALENCES, MASSES, SYMBOLS
from timemachine_torch.graph_utils import Graph, bridges, graph_from_bonds, minimum_cycle_basis

BOND_ORDERS = {1: 1.0, 2: 2.0, 3: 3.0, 4: 1.5}  # SDF order 4 = aromatic


@dataclass
class Atom:
    atomic_num: int
    formal_charge: int = 0
    implicit_h: int = 0  # implicit hydrogens (0 once explicit Hs are added)
    isotope: int = 0

    @property
    def symbol(self) -> str:
        return SYMBOLS[self.atomic_num]

    @property
    def mass(self) -> float:
        return MASSES[self.atomic_num]


@dataclass
class Bond:
    src: int
    dst: int
    order: int  # 1, 2, 3, or 4 (aromatic, as read; kekulized where possible)

    def other(self, idx: int) -> int:
        return self.dst if idx == self.src else self.src


class Mol:
    """Immutable-ish molecular graph. Mutation helpers return new Mols."""

    def __init__(
        self,
        atoms: Sequence[Atom],
        bonds: Sequence[Bond],
        coords: Optional[np.ndarray] = None,  # (N, 3) Å
        name: str = "",
        props: Optional[dict] = None,
    ):
        self.atoms = list(atoms)
        self.bonds = list(bonds)
        n = len(self.atoms)
        self.coords = np.zeros((n, 3)) if coords is None else np.asarray(coords, dtype=np.float64)
        assert self.coords.shape == (n, 3)
        self.name = name
        self.props = dict(props or {})
        self._cache: dict = {}

    # -- construction --------------------------------------------------------

    @classmethod
    def from_arrays(cls, atomic_nums, bond_list, coords=None, formal_charges=None, name="", props=None):
        """bond_list rows: (src, dst, order)."""
        charges = formal_charges if formal_charges is not None else [0] * len(atomic_nums)
        atoms = [Atom(int(z), int(q)) for z, q in zip(atomic_nums, charges)]
        bonds = [Bond(int(i), int(j), int(o)) for i, j, o in bond_list]
        return cls(atoms, bonds, coords, name, props)

    def copy(self) -> "Mol":
        m = Mol(
            [Atom(a.atomic_num, a.formal_charge, a.implicit_h, a.isotope) for a in self.atoms],
            [Bond(b.src, b.dst, b.order) for b in self.bonds],
            self.coords.copy(),
            self.name,
            dict(self.props),
        )
        return m

    # -- basic accessors ------------------------------------------------------

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    @property
    def atomic_nums(self) -> np.ndarray:
        return np.array([a.atomic_num for a in self.atoms], dtype=np.int32)

    @property
    def formal_charges(self) -> np.ndarray:
        return np.array([a.formal_charge for a in self.atoms], dtype=np.int32)

    @property
    def masses(self) -> np.ndarray:
        return np.array([a.mass for a in self.atoms])

    def total_charge(self) -> int:
        return int(sum(a.formal_charge for a in self.atoms))

    def get_conf(self) -> np.ndarray:
        """Conformer in nm (ref fe/utils.py get_romol_conf divides Å by 10)."""
        return self.coords / 10.0

    def set_conf(self, conf_nm: np.ndarray):
        self.coords = np.asarray(conf_nm) * 10.0

    def bond_list(self) -> np.ndarray:
        """(B, 2) int32 of bonded atom pairs."""
        return np.array([[b.src, b.dst] for b in self.bonds], dtype=np.int32).reshape(-1, 2)

    # -- graph topology (cached) ----------------------------------------------

    def _adjacency(self):
        if "adj" not in self._cache:
            adj: list[list[tuple[int, int]]] = [[] for _ in range(self.num_atoms)]
            for bi, b in enumerate(self.bonds):
                adj[b.src].append((b.dst, bi))
                adj[b.dst].append((b.src, bi))
            self._cache["adj"] = adj
        return self._cache["adj"]

    def neighbors(self, i: int) -> list[int]:
        return [j for j, _ in self._adjacency()[i]]

    def get_bond(self, i: int, j: int) -> Optional[Bond]:
        for k, bi in self._adjacency()[i]:
            if k == j:
                return self.bonds[bi]
        return None

    def degree(self, i: int) -> int:
        """Explicit connections."""
        return len(self._adjacency()[i])

    def total_connectivity(self, i: int) -> int:
        """SMARTS 'X': explicit degree + implicit Hs."""
        return self.degree(i) + self.atoms[i].implicit_h

    def total_num_hs(self, i: int) -> int:
        """SMARTS 'H': explicit H neighbors + implicit Hs."""
        nh = sum(1 for j in self.neighbors(i) if self.atoms[j].atomic_num == 1)
        return nh + self.atoms[i].implicit_h

    def valence(self, i: int) -> float:
        """Sum of bond orders (aromatic counted 1.5) + implicit Hs."""
        v = sum(BOND_ORDERS[self.bonds[bi].order] for _, bi in self._adjacency()[i])
        return v + self.atoms[i].implicit_h

    def to_nx(self) -> Graph:
        """Bond graph (ref graph_utils.py:6 convert_to_nx): nodes in atom
        order, edges in bond order."""
        return graph_from_bonds(self.num_atoms, ((b.src, b.dst) for b in self.bonds))

    # -- ring perception -------------------------------------------------------

    def ring_info(self):
        """SSSR-like ring set: list of atom-index tuples (minimum cycle basis)."""
        if "rings" not in self._cache:
            rings = [tuple(cycle) for cycle in minimum_cycle_basis(self.to_nx())]
            self._cache["rings"] = rings
        return self._cache["rings"]

    def _ring_tables(self):
        if "ring_tables" not in self._cache:
            sizes: list[set[int]] = [set() for _ in range(self.num_atoms)]
            ring_bonds: set[tuple[int, int]] = set()
            for ring in self.ring_info():
                k = len(ring)
                for a in ring:
                    sizes[a].add(k)
                for idx in range(k):
                    i, j = ring[idx], ring[(idx + 1) % k]
                    ring_bonds.add((min(i, j), max(i, j)))
            # any bond in a cycle (non-bridge) counts as a ring bond, even if
            # not on a minimum-cycle-basis ring
            g = self.to_nx()
            all_ring_bonds = set(tuple(sorted(e)) for e in g.edges()) - bridges(g)
            self._cache["ring_tables"] = (sizes, all_ring_bonds)
        return self._cache["ring_tables"]

    def atom_ring_sizes(self, i: int) -> set[int]:
        return self._ring_tables()[0][i]

    def atom_in_ring(self, i: int) -> bool:
        return len(self.atom_ring_sizes(i)) > 0 or self.num_ring_bonds(i) > 0

    def bond_in_ring(self, i: int, j: int) -> bool:
        return (min(i, j), max(i, j)) in self._ring_tables()[1]

    def num_ring_bonds(self, i: int) -> int:
        """SMARTS 'x': ring bonds incident to atom i."""
        return sum(1 for j in self.neighbors(i) if self.bond_in_ring(i, j))

    # -- aromaticity -----------------------------------------------------------

    def aromatic_atoms(self, model: str = "mdl") -> set[int]:
        key = ("arom_atoms", model)
        if key not in self._cache:
            from timemachine_torch.chem.aromaticity import perceive_aromaticity

            atoms, bonds = perceive_aromaticity(self, model)
            self._cache[("arom_atoms", model)] = atoms
            self._cache[("arom_bonds", model)] = bonds
        return self._cache[key]

    def aromatic_bonds(self, model: str = "mdl") -> set[tuple[int, int]]:
        self.aromatic_atoms(model)
        return self._cache[("arom_bonds", model)]

    def is_aromatic_atom(self, i: int, model: str = "mdl") -> bool:
        return i in self.aromatic_atoms(model)

    def is_aromatic_bond(self, i: int, j: int, model: str = "mdl") -> bool:
        return (min(i, j), max(i, j)) in self.aromatic_bonds(model)

    # -- editing ---------------------------------------------------------------

    def renumber(self, perm) -> "Mol":
        """New Mol with atoms reordered: new index n holds old atom perm[n]
        (RDKit RenumberAtoms semantics)."""
        perm = list(map(int, perm))
        assert sorted(perm) == list(range(self.num_atoms))
        old_to_new = {old: new for new, old in enumerate(perm)}
        atoms = [Atom(self.atoms[o].atomic_num, self.atoms[o].formal_charge, self.atoms[o].implicit_h, self.atoms[o].isotope) for o in perm]
        bonds = [Bond(old_to_new[b.src], old_to_new[b.dst], b.order) for b in self.bonds]
        return Mol(atoms, bonds, self.coords[perm], self.name, dict(self.props))

    def add_hydrogens(self) -> "Mol":
        """Materialize implicit hydrogens as explicit atoms (no coordinates
        generated; use embedding to place them)."""
        atoms = [Atom(a.atomic_num, a.formal_charge, 0, a.isotope) for a in self.atoms]
        bonds = [Bond(b.src, b.dst, b.order) for b in self.bonds]
        coords = [self.coords[i] for i in range(self.num_atoms)]
        for i, a in enumerate(self.atoms):
            for _ in range(a.implicit_h):
                atoms.append(Atom(1, 0, 0))
                bonds.append(Bond(i, len(atoms) - 1, 1))
                coords.append(self.coords[i] + np.random.default_rng(len(atoms)).normal(0, 0.1, 3))
        return Mol(atoms, bonds, np.array(coords), self.name, dict(self.props))

    def __repr__(self):
        return f"Mol(name={self.name!r}, atoms={self.num_atoms}, bonds={self.num_bonds})"
