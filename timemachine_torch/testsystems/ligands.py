"""Small torsion test ligands (counterpart of
timemachine_tpu/testsystems/ligands.py): a fluorinated biphenyl and
triphenyl built from SMILES with the port's embedder, each with the index
lists of its inter-ring rotatable torsions.
"""

import numpy as np

from timemachine_torch.chem import mol_from_smiles
from timemachine_torch.chem.embed import embed_mol


def _build(smiles: str, seed: int):
    mol = mol_from_smiles(smiles)
    embed_mol(mol, seed=seed)
    return mol


def get_biphenyl():
    """2,6-difluoro-biphenyl-like torsion system.

    Returns (mol, torsion_idxs) where the torsion spans the inter-ring bond."""
    # ring A (atoms 0-5, F at 6 and 7 on the 2,6 positions), ring B (8-13), F at 14
    mol = _build("Fc1cccc(F)c1-c1ccccc1F", seed=7)
    # locate the inter-ring bond: the two aromatic atoms bonded across rings
    inter = None
    ring_sets = [set(r) for r in mol.ring_info()]
    for b in mol.bonds:
        in_same = any(b.src in rs and b.dst in rs for rs in ring_sets)
        both_arom = b.src in mol.aromatic_atoms() and b.dst in mol.aromatic_atoms()
        if both_arom and not in_same:
            inter = (b.src, b.dst)
            break
    assert inter is not None
    j, k = inter
    i = next(b.other(j) for b in mol.bonds if (j in (b.src, b.dst)) and b.other(j) != k)
    l = next(b.other(k) for b in mol.bonds if (k in (b.src, b.dst)) and b.other(k) != j)
    torsion_idxs = np.array([[i, j, k, l]])
    return mol, torsion_idxs


def get_triphenyl():
    """Three-ring torsion system."""
    mol = _build("Fc1cccc(F)c1-c1cc(F)ccc1-c1ccccc1F", seed=8)
    ring_sets = [set(r) for r in mol.ring_info()]
    arom = mol.aromatic_atoms()
    torsions = []
    for b in mol.bonds:
        in_same = any(b.src in rs and b.dst in rs for rs in ring_sets)
        if b.src in arom and b.dst in arom and not in_same:
            j, k = b.src, b.dst
            i = next(bb.other(j) for bb in mol.bonds if (j in (bb.src, bb.dst)) and bb.other(j) != k)
            l = next(bb.other(k) for bb in mol.bonds if (k in (bb.src, bb.dst)) and bb.other(k) != j)
            torsions.append([i, j, k, l])
    assert len(torsions) == 2
    return mol, np.array(sorted(torsions))
