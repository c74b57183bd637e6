"""The probe-in-water system of the water-sampling examples and its
observables (counterpart of examples/water_sampling_common.py): a rigid
probe molecule (by default the adamantane cage) embedded from SMILES and
solvated in the port's TIP3P water box, which the examples decouple over
an AHFE λ ladder with the TIBD water sampler on.
"""

from __future__ import annotations

import numpy as np

from timemachine_torch.constants import AVOGADRO
from timemachine_torch.md.exchange.exchange_mover import delta_r_np

DEFAULT_BB_RADIUS = 0.46  # nm
PROBE_SMILES = "C1C2CC3CC1CC(C2)C3"


def compute_density(n_waters, box):
    """kg/m^3 of n_waters in the box."""
    box_vol = np.prod(np.diag(box))
    return n_waters * 18.01528 * 1e27 / (box_vol * AVOGADRO * 1000)


def compute_occupancy(x_t, box_t, ligand_idxs, threshold):
    """The number of atoms within threshold of the ligand's centroid."""
    centroid = np.mean(x_t[ligand_idxs], axis=0)
    dijs = np.linalg.norm(delta_r_np(centroid[None, :], x_t, box_t), axis=-1)
    return int(np.sum(dijs < threshold))


def build_probe_in_water(smiles=PROBE_SMILES, box_width=3.0, seed=2024):
    """(mol, host_config): the probe embedded with `seed`, in a water box of
    side box_width nm with the waters that clash with it left out."""
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.chem.embed import embed_mol
    from timemachine_torch.md.builders import build_water_system

    mol = mol_from_smiles(smiles, add_hs=True, name="probe")
    embed_mol(mol, seed=seed)
    host_config = build_water_system(box_width, mols=[mol])
    return mol, host_config
