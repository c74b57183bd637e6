"""Ligand/conformer utilities (the port's copy of the conformer, mass, SDF,
seed-hash, bond and 2D-projection helpers of timemachine_tpu/fe/utils.py;
its atom-mapping grid drawing and energy-table helpers are not ported)."""

from __future__ import annotations

import numpy as np

from timemachine_torch.chem.mol import Mol


def get_romol_conf(mol: Mol, conf_id: int = 0) -> np.ndarray:
    """Conformer in nm (ref fe/utils.py get_romol_conf)."""
    del conf_id
    return mol.get_conf()


def set_romol_conf(mol: Mol, conf_nm: np.ndarray, conf_id: int = 0):
    del conf_id
    mol.set_conf(conf_nm)


def get_mol_name(mol: Mol) -> str:
    if mol.name:
        return mol.name
    if "_Name" in mol.props:
        return str(mol.props["_Name"])
    raise KeyError("mol has no name")


def set_mol_name(mol: Mol, name: str):
    mol.name = name


def get_mol_masses(mol: Mol) -> np.ndarray:
    return mol.masses


def read_sdf(path):
    from timemachine_torch.chem.sdf import read_sdf as _read

    return _read(path)


def read_sdf_mols_by_name(path):
    return {get_mol_name(m): m for m in read_sdf(path)}


def bytes_to_id(data: bytes) -> int:
    """Deterministic 64-bit id from bytes (ref fe/utils.py:589-592); used to
    derive per-window seeds symmetric under A->B vs B->A edge direction."""
    import hashlib

    return int(hashlib.sha256(data).hexdigest(), 16) % (2**64 - 1)


def get_romol_bonds(mol: Mol) -> np.ndarray:
    """(B, 2) bond indices (ref fe/utils.py:437-445)."""
    return np.array([[b.src, b.dst] for b in mol.bonds], dtype=np.int32)


def recenter_mol(mol: Mol) -> Mol:
    """A copy of mol with its conformer centred on its centroid."""
    import copy

    mol_copy = copy.deepcopy(mol)
    conf = get_romol_conf(mol)
    mol_copy.set_conf(conf - np.mean(conf, axis=0))
    return mol_copy


def score_2d(conf, norm=2):
    """Crowding of a conformer's 2D projection: low when atoms are spread."""
    score = 0.0
    for idx, (x0, y0, _) in enumerate(conf):
        for x1, y1, _ in conf[idx + 1 :]:
            score += 1 / ((x0 - x1) ** norm + (y0 - y1) ** norm)
    return score / len(conf)


def generate_good_rotations(mol_a, mol_b, num_rotations: int = 3, max_rotations: int = 1000, seed: int = 1234):
    """The num_rotations of max_rotations random rotations (numpy, from
    seed) whose 2D projections of both molecules are least crowded."""
    assert num_rotations < max_rotations
    conf_a = get_romol_conf(mol_a)
    conf_b = get_romol_conf(mol_b)
    rng = np.random.default_rng(seed)

    def random_so3():
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )

    scores, rotations = [], []
    for _ in range(max_rotations):
        r = random_so3()
        scores.append(max(score_2d(conf_a @ r.T), score_2d(conf_b @ r.T)))
        rotations.append(r)
    perm = np.argsort(scores, kind="stable")
    return np.array(rotations)[perm][:num_rotations]
