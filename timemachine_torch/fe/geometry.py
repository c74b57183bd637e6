"""Local-geometry classification of atoms (the port of
timemachine_tpu/fe/geometry.py, on the port's chem.Mol).

The reference derives geometry from RDKit hybridization; here hybridization
is inferred from the native Mol's bond orders/aromaticity (triple or
cumulated-double -> SP, any double/aromatic -> SP2, else SP3), which
reproduces the same LocalGeometry classes for standard organic chemistry.
"""

from enum import Enum


class LocalGeometry(Enum):
    G1_TERMINAL = 0  # R-X
    G2_KINK = 1  # R-X-H
    G2_LINEAR = 2  # R-X#N
    G3_PLANAR = 3  # R-X(=O)O
    G3_PYRAMIDAL = 4  # R-X(-H)H
    G4_TETRAHEDRAL = 5  # R-X(-H)(-H)H


def _hybridization(mol, atom_idx: int) -> int:
    """3 = sp3, 2 = sp2, 1 = sp, inferred from bond orders."""
    n_double = 0
    n_triple = 0
    aromatic = atom_idx in mol.aromatic_atoms()
    for b in mol.bonds:
        if atom_idx not in (b.src, b.dst):
            continue
        if b.order == 3:
            n_triple += 1
        elif b.order == 2:
            n_double += 1
    if n_triple > 0 or n_double >= 2:
        return 1
    if n_double == 1 or aromatic:
        return 2
    return 3


def assign_atom_geometry(mol, atom_idx: int) -> LocalGeometry:
    """(ref geometry.py:18-52)"""
    n_nbrs = sum(1 for b in mol.bonds if atom_idx in (b.src, b.dst))
    hyb = _hybridization(mol, atom_idx)
    if n_nbrs == 0:
        raise AssertionError("Ion not supported")
    if n_nbrs == 1:
        return LocalGeometry.G1_TERMINAL
    if n_nbrs == 2:
        if hyb in (3, 2):
            return LocalGeometry.G2_KINK
        if hyb == 1:
            return LocalGeometry.G2_LINEAR
        raise AssertionError("Unknown 2-nbr geometry!")
    if n_nbrs == 3:
        if hyb == 3:
            return LocalGeometry.G3_PYRAMIDAL
        if hyb == 2:
            return LocalGeometry.G3_PLANAR
        raise AssertionError("Unknown 3-nbr geometry")
    if n_nbrs == 4:
        if hyb == 3:
            return LocalGeometry.G4_TETRAHEDRAL
        raise AssertionError("Unknown 4-nbr geometry")
    raise AssertionError("Too many neighbors")


def classify_geometry(mol) -> list:
    """Per-atom LocalGeometry list (ref geometry.py:55-77)."""
    return [assign_atom_geometry(mol, i) for i in range(mol.num_atoms)]
