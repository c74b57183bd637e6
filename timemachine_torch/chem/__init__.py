"""Native mini-cheminformatics kit.

The port's copy of timemachine_tpu/chem/__init__.py.

Replaces the reference's RDKit dependency for the subset of functionality the
framework needs: molecular graphs, SDF I/O, SMILES construction, ring/
aromaticity perception, and SMARTS/SMIRKS substructure matching (the engine
behind forcefield parameter assignment, ref ff/handlers/utils.py:72-106).
"""

from timemachine_torch.chem.mol import Mol, Atom, Bond
from timemachine_torch.chem.sdf import read_sdf, read_sdf_string, write_sdf
from timemachine_torch.chem.smiles import mol_from_smiles
from timemachine_torch.chem.smarts import SmartsPattern, match_smarts

__all__ = [
    "Mol",
    "Atom",
    "Bond",
    "read_sdf",
    "read_sdf_string",
    "write_sdf",
    "mol_from_smiles",
    "SmartsPattern",
    "match_smarts",
]
