"""Bond queries for REST's region selection (counterpart of
timemachine_tpu/fe/rest/queries.py)."""

from __future__ import annotations

from timemachine_torch.chem.smarts import match_smarts
from timemachine_torch.fe.rest.bond import CanonicalBond, mkbond
from timemachine_torch.md.enhanced import ROTATABLE_BOND_SMARTS


def get_aliphatic_ring_bonds(mol) -> set:
    """The bonds of the rings of Mol.ring_info() that are not fully aromatic."""
    out: set[CanonicalBond] = set()
    for ring in mol.ring_info():
        ring_set = set(ring)
        # a minimal cycle has no chords: every bond within its atom set is a ring bond
        pairs = [(b.src, b.dst) for b in mol.bonds if b.src in ring_set and b.dst in ring_set]
        if not all(mol.is_aromatic_bond(i, j) for i, j in pairs):
            out |= {mkbond(i, j) for i, j in pairs}
    return out


def get_rotatable_bonds(mol) -> set:
    """Lipinski-style (non-strict) rotatable bonds."""
    return {mkbond(i, j) for i, j in match_smarts(mol, ROTATABLE_BOND_SMARTS, uniquify=True)}
