"""Ligand/conformer utilities (the port's copy of the conformer, mass, SDF,
seed-hash and bond helpers of timemachine_tpu/fe/utils.py; its drawing and
energy-table helpers are not ported)."""

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
