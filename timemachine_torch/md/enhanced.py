"""The rotatable-bond query of timemachine_tpu/md/enhanced.py (its
ROTATABLE_BOND_SMARTS and identify_rotatable_bonds), which REST's region
selection reads. The rest of that module (VacuumState, simulate_batch and
the enhanced-sampling drivers) is not ported."""

from __future__ import annotations

from timemachine_torch.chem.smarts import match_smarts

ROTATABLE_BOND_SMARTS = "[!$(*#*)&!D1]-&!@[!$(*#*)&!D1]"


def identify_rotatable_bonds(mol) -> set:
    """Rotatable bonds by the Lipinski-style (non-strict) SMARTS, as
    canonicalized (i < j) pairs."""
    return {(min(i, j), max(i, j)) for i, j in match_smarts(mol, ROTATABLE_BOND_SMARTS)}
