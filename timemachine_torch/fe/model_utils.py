"""Hydrogen mass repartitioning (same rule as timemachine_tpu/fe/model_utils.py),
the vacuum energy of a ligand for its minimization, and the imaging of a
frame's molecules into the box."""

from __future__ import annotations

import numpy as np


def image_frame(group_idxs, coords, box):
    """Each molecule moved whole by box vectors so its centroid lies in the home box (numpy)."""
    from timemachine_torch.ops.pbc import image_molecules

    return image_molecules(coords, box, group_idxs)


def apply_hmr(masses, bond_list, multiplier=2):
    """Each H gains `multiplier` x its own mass, taken from its bonded heavy
    atom; total mass is conserved. Enables dt = 2.5 fs without constraints."""
    masses = np.array(masses, dtype=np.float64)

    def is_hydrogen(i):
        return np.abs(masses[i] - 1.00794) < 1e-3

    for i, j in bond_list:
        i, j = np.array([i, j])[np.argsort([masses[i], masses[j]], kind="stable")]
        if is_hydrogen(i):
            if is_hydrogen(j):
                continue
            masses[j] -= multiplier * masses[i]
            masses[i] += multiplier * masses[i]
    return masses


def verify_chiral_validity_of_core(mol_a, mol_b, core, ff):
    """Raise ValueError when the core maps a chiral center of mol_a onto one
    of mol_b's with the opposite chirality."""
    from timemachine_torch.fe import chiral_utils
    from timemachine_torch.fe.utils import get_romol_conf

    chiral_set_a = chiral_utils.ChiralRestrIdxSet.from_mol(mol_a, get_romol_conf(mol_a))
    chiral_set_b = chiral_utils.ChiralRestrIdxSet.from_mol(mol_b, get_romol_conf(mol_b))
    conflicts = chiral_utils.find_atom_map_chiral_conflicts(np.asarray(core), chiral_set_a, chiral_set_b)
    if conflicts:
        raise ValueError(f"core has chiral conflicts: {conflicts}")


def get_vacuum_val_and_grad_fn(mol, ff, device=None):
    """coords (numpy) -> (U, dU/dx) of mol's end-state potentials in vacuum,
    float64 (md/minimizer.py get_val_and_grad_fn over BaseTopology's end
    state), on `device` (None: the card)."""
    from timemachine_torch.device import resolve_device, working_dtype
    from timemachine_torch.fe.topology import BaseTopology
    from timemachine_torch.md.minimizer import get_val_and_grad_fn

    device = resolve_device(device)
    system = BaseTopology(mol, ff).setup_end_state().to_system(mol.num_atoms, device=device, dtype=working_dtype(device))
    return get_val_and_grad_fn([m for m in system.get_U_fns() if m.params.numel() > 0], None)
