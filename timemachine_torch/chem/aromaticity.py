"""Aromaticity perception.

The port's copy of timemachine_tpu/chem/aromaticity.py.

Two models, matching the two the reference's handlers use:

* "mdl"    — RDKit AROMATICITY_MDL semantics (used for valence/LJ SMIRKS
             assignment, ref ff/handlers/utils.py:84-85): 6-membered rings of
             C/N only, each ring atom carrying exactly one in-ring double
             bond (Kekulé alternation); fused systems handled because shared
             bonds are ring bonds. 5-membered heteroaromatics (pyrrole,
             furan) are NOT aromatic under this model.

* "am1bcc" — the Jakalian, Jack & Bayly AM1BCC aromaticity algorithm (used by
             the bond-charge-correction handlers, ref ff/handlers/
             bcc_aromaticity.py:125-320): five SMIRKS-defined cases applied
             iteratively over X/Y/Z atom types, growing ar6 assignments then
             adding ar5 rings.
"""

from __future__ import annotations

from timemachine_torch.chem.mol import Mol


def _canon(i: int, j: int) -> tuple[int, int]:
    return (min(i, j), max(i, j))


def _mdl_aromaticity(mol: Mol) -> tuple[set, set]:
    arom_atoms: set[int] = set()
    arom_bonds: set[tuple[int, int]] = set()
    for ring in mol.ring_info():
        if len(ring) != 6:
            continue
        zs = [mol.atoms[a].atomic_num for a in ring]
        if not all(z in (6, 7) for z in zs):
            continue
        ring_set = set(ring)
        # drawn-aromatic input (SDF bond order 4 on every ring bond)
        orders = []
        ok = True
        for idx in range(6):
            b = mol.get_bond(ring[idx], ring[(idx + 1) % 6])
            if b is None:
                ok = False
                break
            orders.append(b.order)
        if not ok:
            continue
        if all(o == 4 for o in orders):
            aromatic = True
        else:
            # Kekulé alternation: each ring atom has exactly one double bond,
            # and that double bond is a ring bond (possibly of a fused ring)
            aromatic = True
            for a in ring:
                n_double_in_ring_sys = 0
                for nb in mol.neighbors(a):
                    b = mol.get_bond(a, nb)
                    if b.order == 2:
                        if mol.bond_in_ring(a, nb):
                            n_double_in_ring_sys += 1
                        else:
                            aromatic = False  # exocyclic double bond
                if n_double_in_ring_sys != 1:
                    aromatic = False
                if not aromatic:
                    break
        if aromatic:
            arom_atoms.update(ring_set)
            for idx in range(6):
                arom_bonds.add(_canon(ring[idx], ring[(idx + 1) % 6]))
    return arom_atoms, arom_bonds


# X/Y/Z atom types of the AM1BCC paper (ref bcc_aromaticity.py:199-201)
_X_TYPE = "[#6X3,#7X2,#15X2,#7X3+1,#15X3+1,#8X2+1,#16X2+1:N]"
_Y_TYPE = "[#6X2-1,#7X2-1,#8X2,#16X2,#7X3,#15X3:N]"


def _fill(template: str, n: int) -> str:
    return template.replace("N", str(n))


def _am1bcc_aromaticity(mol: Mol) -> tuple[set, set]:
    from timemachine_torch.chem.smarts import match_smarts

    x, y, z = _X_TYPE, _Y_TYPE, _X_TYPE
    arom_atoms: set[int] = set()
    arom_bonds: set[tuple[int, int]] = set()

    def matches_of(smirks):
        out = match_smarts(mol, smirks, arom_atoms=arom_atoms, arom_bonds=arom_bonds, uniquify=True)
        return out

    def set_aromatic(matches):
        for m in matches:
            ring_atoms = set(m)
            arom_atoms.update(ring_atoms)
            for i in ring_atoms:
                for j in mol.neighbors(i):
                    if j in ring_atoms and mol.bond_in_ring(i, j):
                        arom_bonds.add(_canon(i, j))

    # Case 1: fully alternating 6-ring of X-type atoms
    case_1 = f"{_fill(x,1)}1=@{_fill(x,2)}-@{_fill(x,3)}=@{_fill(x,4)}-@{_fill(x,5)}=@{_fill(x,6)}-@1"
    c1 = matches_of(case_1)
    case_1_atoms = {a for m in c1 for a in m}
    set_aromatic(c1)
    ar6 = set(case_1_atoms)

    # Case 2: 6-ring with one aromatic bond to already-ar6 atoms (iterate)
    case_2 = f"{_fill(x,1)}1=@{_fill(x,2)}-@{_fill(x,3)}=@{_fill(x,4)}-@{_fill(x,5)}:@{_fill(x,6)}-@1"
    prev = None
    case_2_atoms: set[int] = set()
    while prev != case_2_atoms:
        c2 = [m for m in matches_of(case_2) if m[4] in ar6 and m[5] in ar6]
        prev = case_2_atoms
        case_2_atoms = {a for m in c2 for a in m}
        ar6.update(case_2_atoms)
        set_aromatic(c2)

    # Case 3: 6-ring with two aromatic bonds into ar6 (iterate)
    case_3 = f"{_fill(x,1)}1=@{_fill(x,2)}-@{_fill(x,3)}:@{_fill(x,4)}~@{_fill(x,5)}:@{_fill(x,6)}-@1"
    prev = None
    case_3_atoms: set[int] = set()
    while prev != case_3_atoms:
        c3 = [m for m in matches_of(case_3) if m[2] in ar6 and m[3] in ar6 and m[4] in ar6 and m[5] in ar6]
        prev = case_3_atoms
        case_3_atoms = {a for m in c3 for a in m}
        ar6.update(case_3_atoms)
        set_aromatic(c3)

    # Case 4: tropylium-like 7-ring with C+
    case_4 = (
        f"[#6+1:1]1-@{_fill(x,2)}=@{_fill(x,3)}-@{_fill(x,4)}=@{_fill(x,5)}-@{_fill(x,6)}=@{_fill(x,7)}-@1"
    )
    c4 = matches_of(case_4)
    case_4_atoms = {a for m in c4 for a in m}
    set_aromatic(c4)

    # Case 5: 5-ring with Y-type lone-pair donor, not already counted ar6/ar7
    ar_67 = case_1_atoms | case_2_atoms | case_3_atoms | case_4_atoms
    case_5 = f"{_fill(y,1)}1-@{_fill(z,2)}=@{_fill(z,3)}-@{_fill(x,4)}=@{_fill(x,5)}-@1"
    c5 = [m for m in matches_of(case_5) if m[1] not in ar_67 and m[2] not in ar_67]
    set_aromatic(c5)

    return arom_atoms, arom_bonds


def perceive_aromaticity(mol: Mol, model: str = "mdl") -> tuple[set, set]:
    if model == "mdl":
        return _mdl_aromaticity(mol)
    if model == "am1bcc":
        return _am1bcc_aromaticity(mol)
    raise ValueError(f"unknown aromaticity model {model!r}")
