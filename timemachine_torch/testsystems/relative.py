"""Relative-transformation test systems on hif2a's ligands_40.sdf
(counterpart of timemachine_tpu/testsystems/relative.py), read from the
public data directory (testsystems/data.py), which the repository lacks.
"""

import numpy as np

from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS
from timemachine_torch.fe import atom_mapping
from timemachine_torch.fe.single_topology import SingleTopology
from timemachine_torch.fe.utils import get_romol_conf, read_sdf
from timemachine_torch.ff import Forcefield
from timemachine_torch.testsystems.data import path_to_data

# the hand-made mapping between ligands_40.sdf molecules 1 and 4
_HIF2A_PAIR_CORE = np.array(
    [
        [0, 0], [2, 2], [1, 1], [6, 6], [5, 5], [4, 4], [3, 3],
        [15, 16], [16, 17], [17, 18], [18, 19], [19, 20], [20, 21],
        [32, 30], [26, 25], [27, 26], [7, 7], [8, 8], [9, 9], [10, 10],
        [29, 11], [11, 12], [12, 13], [14, 15], [31, 29], [13, 14],
        [23, 24], [30, 28], [28, 27], [21, 22],
    ]
)


def _load_ligands_40():
    return read_sdf(path_to_data("data", "ligands_40.sdf"))


def get_hif2a_ligand_pair_single_topology():
    """Two hif2a ligands and the hand-made atom mapping."""
    all_mols = _load_ligands_40()
    return all_mols[1], all_mols[4], _HIF2A_PAIR_CORE.copy()


def get_hif2a_ligand_pair_single_topology_chiral_volume():
    """Chiral CF3 (mol_a) morphed to achiral NH2 (mol_b)."""
    all_mols = _load_ligands_40()
    mol_a, mol_b = all_mols[11], all_mols[-7]
    core = atom_mapping.get_cores(mol_a, mol_b, **DEFAULT_ATOM_MAPPING_KWARGS)[0]
    return mol_a, mol_b, core


def get_hif2a_ligand_pair(src_idx, dst_idx):
    """Ligands src_idx and dst_idx of ligands_40.sdf and their first MCS core."""
    all_mols = _load_ligands_40()
    mol_a, mol_b = all_mols[src_idx], all_mols[dst_idx]
    core = atom_mapping.get_cores(mol_a, mol_b, **DEFAULT_ATOM_MAPPING_KWARGS)[0]
    return mol_a, mol_b, core


def get_relative_hif2a_in_vacuum(device=None):
    """Vacuum intermediate state of the hif2a pair at lambda = 0.5, its
    potentials on `device` (None: the card)."""
    from timemachine_torch.fe.rbfe import setup_initial_states

    mol_a, mol_b, core = get_hif2a_ligand_pair_single_topology()
    ff = Forcefield.load_default()
    rfe = SingleTopology(mol_a, mol_b, core, ff)

    initial_states = setup_initial_states(rfe, None, 300.0, [0.5], seed=2022, device=device)
    potentials = initial_states[0].potentials
    sys_params = [p.params.detach().cpu().numpy().astype(np.float64) for p in potentials]
    coords = rfe.combine_confs(get_romol_conf(mol_a), get_romol_conf(mol_b))
    masses = np.array(rfe.combine_masses())
    return potentials, sys_params, coords, masses
