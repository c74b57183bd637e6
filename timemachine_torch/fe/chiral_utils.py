"""Chirality bookkeeping for alchemical transformations.

The port's copy of timemachine_tpu/fe/chiral_utils.py.

Parity target: reference timemachine/fe/chiral_utils.py — find chiral atoms/
bonds, set up restraint index tuples from a conformer, and check atom maps
for chiral conflicts. Uses this framework's native SMARTS engine."""

from __future__ import annotations

import itertools
from enum import Enum

import numpy as np

from timemachine_torch.chem.mol import Mol
from timemachine_torch.chem.smarts import match_smarts
from timemachine_torch.ff.handlers import canonicalize_bond


# host-side (numpy) volume evaluations: the setup loops below call these per
# quartet, where a device op would cost a round trip per call. The torch
# twins for potentials live in ops/chiral.py.
def _np_unit(x):
    return x / np.linalg.norm(x)


def pyramidal_volume(xc, x1, x2, x3) -> float:
    v0 = _np_unit(np.asarray(x1) - np.asarray(xc))
    v1 = _np_unit(np.asarray(x2) - np.asarray(xc))
    v2 = _np_unit(np.asarray(x3) - np.asarray(xc))
    return float(np.dot(np.cross(v0, v1), v2))


def torsion_volume(ci, cj, ck, cl) -> float:
    rij = _np_unit(np.asarray(cj) - np.asarray(ci))
    rkj = _np_unit(np.asarray(cj) - np.asarray(ck))
    rkl = _np_unit(np.asarray(cl) - np.asarray(ck))
    return float(np.dot(np.cross(rij, rkj), np.cross(rkj, rkl)))


class ChiralCheckMode(Enum):
    FLIP = 1
    UNDEFINED = 2


def find_chiral_atoms(mol: Mol) -> set[int]:
    """Atoms with non-invertible pyramidal geometry (incl. CH4-like centers)
    (ref chiral_utils.py:124-160)."""
    chiral_patterns = [
        "[X4:1]",
        "[#16X3,#15X3:1]",
        "[#7X3:1](~F)(~F)~F",
    ]
    chiral_atoms = set()
    for patt in chiral_patterns:
        for m in match_smarts(mol, patt):
            chiral_atoms.add(m[0])
    return chiral_atoms


def setup_chiral_atom_restraints(mol: Mol, conf, a_idx: int):
    """For each 3-combination of neighbors, orient the tuple so the current
    geometry has negative pyramidal volume (ref chiral_utils.py:29-65)."""
    nbs = mol.neighbors(a_idx)
    restr_idxs = []
    for i, j, k in itertools.combinations(nbs, 3):
        vol = float(pyramidal_volume(conf[a_idx], conf[i], conf[j], conf[k]))
        if vol < 0:
            restr_idxs.append((a_idx, i, j, k))
        else:
            restr_idxs.append((a_idx, j, i, k))
    return restr_idxs


def setup_all_chiral_atom_restr_idxs(mol: Mol, conf) -> list[tuple]:
    chiral_atom_set = find_chiral_atoms(mol)
    out: list[tuple] = []
    for a_idx in sorted(chiral_atom_set):
        for ii in setup_chiral_atom_restraints(mol, conf, a_idx):
            assert ii not in out
            out.append(ii)
    return out


def find_chiral_bonds(mol: Mol) -> set[tuple[int, int]]:
    """Double bonds + amides: high-rotational-barrier bonds
    (ref chiral_utils.py:306-336)."""
    chiral_patterns = [
        "[X2,X3:1]=[X2,X3:2]",
        "[NX3,NX2:1][CX3:2](=[OX1])",
    ]
    chiral_bonds = set()
    for patt in chiral_patterns:
        for m in match_smarts(mol, patt):
            chiral_bonds.add(tuple(sorted((m[0], m[1]))))
    return chiral_bonds


def setup_chiral_bond_restraints(mol: Mol, conf, src_idx: int, dst_idx: int):
    """(ref chiral_utils.py:68-121)"""
    src_nbs = list(mol.neighbors(src_idx))
    dst_nbs = list(mol.neighbors(dst_idx))
    assert src_idx in dst_nbs and dst_idx in src_nbs
    src_nbs.remove(dst_idx)
    dst_nbs.remove(src_idx)
    restr_idxs, signs = [], []
    b, c = src_idx, dst_idx
    for a in src_nbs:
        for d in dst_nbs:
            vol = float(torsion_volume(conf[a], conf[b], conf[c], conf[d]))
            restr_idxs.append((a, b, c, d))
            signs.append(1 if vol < 0 else -1)
    return restr_idxs, signs


def find_canonical_amide_bonds(mol: Mol) -> set:
    return {
        tuple(canonicalize_bond((m[0], m[1])))
        for m in match_smarts(mol, "[NX3][CX3](=[OX1])[#6]")
    }


class ChiralRestrIdxSet:
    """Fast chirality-consistency checks for trial 4-tuples
    (ref chiral_utils.py:175-210)."""

    def __init__(self, restr_idxs):
        self.restr_idxs = [tuple(map(int, r)) for r in restr_idxs]
        self.allowed_set, self.disallowed_set = self.expand_symmetries()

    @classmethod
    def from_mol(cls, mol: Mol, conf):
        return cls(setup_all_chiral_atom_restr_idxs(mol, conf))

    def expand_symmetries(self):
        allowed, disallowed = set(), set()
        for center, i, j, k in self.restr_idxs:
            allowed.add((center, i, j, k))
            allowed.add((center, j, k, i))
            allowed.add((center, k, i, j))
            disallowed.add((center, i, k, j))
            disallowed.add((center, j, i, k))
            disallowed.add((center, k, j, i))
        assert allowed.isdisjoint(disallowed)
        return allowed, disallowed

    def defines(self, trial_tuple) -> bool:
        return trial_tuple in self.allowed_set or trial_tuple in self.disallowed_set

    def disallows(self, trial_tuple) -> bool:
        return trial_tuple in self.disallowed_set


def enumerate_simple_paths(graph, length: int):
    """All simple paths of `length` nodes in the bond graph."""
    paths = []
    for src in graph.nodes():
        stack = [(src,)]
        while stack:
            path = stack.pop()
            if len(path) == length:
                paths.append(path)
                continue
            for nb in graph.neighbors(path[-1]):
                if nb not in path:
                    stack.append(path + (nb,))
    return paths


def enumerate_planar_torsions(mol: Mol) -> dict:
    """(i,j,k,l) -> sign(torsion volume) for torsions whose central bond is
    double/aromatic/amide (ref chiral_utils.py:345-380)."""
    import numpy as np

    conf = mol.get_conf()
    graph = mol.to_nx()
    idxs = {tuple(canonicalize_bond(list(p))) for p in enumerate_simple_paths(graph, 4)}
    amide_bonds = find_canonical_amide_bonds(mol)
    planar_torsions = {}
    for i, j, k, l in idxs:
        if tuple(canonicalize_bond((j, k))) not in amide_bonds:
            bond = mol.get_bond(j, k)
            is_aromatic = mol.is_aromatic_bond(j, k, "mdl")
            if bond is None or (bond.order != 2 and not is_aromatic and bond.order != 4):
                continue
        volume = float(torsion_volume(conf[i], conf[j], conf[k], conf[l]))
        planar_torsions[(i, j, k, l)] = np.sign(volume)
    return planar_torsions


def setup_find_flipped_planar_torsions(mol_a: Mol, mol_b: Mol):
    """Returns core -> iterator of planar torsions (central bond double/
    aromatic/amide) whose torsion-volume sign flips under the mapping
    (ref chiral_utils.py:345-407)."""
    planar_torsions_a = enumerate_planar_torsions(mol_a)
    planar_torsions_b = enumerate_planar_torsions(mol_b)
    planar_torsions_b.update({(l, k, j, i): s for (i, j, k, l), s in planar_torsions_b.items()})

    def find_flipped(core):
        for (ia, ja, ka, la), sign_a in planar_torsions_a.items():
            idxs_b = (core[ia], core[ja], core[ka], core[la])
            sign_b = planar_torsions_b.get(idxs_b)
            if sign_b is not None and sign_a != sign_b:
                yield ((ia, ja, ka, la), idxs_b)

    return find_flipped


def _find_atom_map_chiral_conflicts_one_direction(core, chiral_set_a, chiral_set_b, mode=ChiralCheckMode.FLIP):
    if mode == ChiralCheckMode.FLIP:
        conflict_fn = chiral_set_b.disallows
    elif mode == ChiralCheckMode.UNDEFINED:
        conflict_fn = lambda t: not chiral_set_b.defines(t)
    else:
        raise ValueError("invalid chiral check mode")

    mapped_set_a = set(int(x) for x in core[:, 0])
    mapping = {int(a): int(b) for a, b in core}
    conflicts = set()
    for restr_tuple_a in chiral_set_a.restr_idxs:
        if set(restr_tuple_a).issubset(mapped_set_a):
            mapped_b = tuple(mapping[x] for x in restr_tuple_a)
            if conflict_fn(mapped_b):
                conflicts.add((restr_tuple_a, mapped_b))
    return conflicts


def has_chiral_atom_flips(core, chiral_set_a: ChiralRestrIdxSet, chiral_set_b: ChiralRestrIdxSet) -> bool:
    """core here is a dense a->b index map (ref chiral_utils.py:246-260)."""
    for c_a, i_a, j_a, k_a in chiral_set_a.restr_idxs:
        mapped = (core[c_a], core[i_a], core[j_a], core[k_a])
        if chiral_set_b.disallows(mapped):
            return True
    return False


def find_atom_map_chiral_conflicts(core, chiral_set_a, chiral_set_b, mode=ChiralCheckMode.FLIP):
    core = np.asarray(core)
    conflicts = _find_atom_map_chiral_conflicts_one_direction(core, chiral_set_a, chiral_set_b, mode)
    conflicts_rev = _find_atom_map_chiral_conflicts_one_direction(core[:, ::-1], chiral_set_b, chiral_set_a, mode)
    return conflicts | {(a, b) for (b, a) in conflicts_rev}
