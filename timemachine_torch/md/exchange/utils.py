"""Exchange-move helpers (counterpart of timemachine_tpu/md/exchange/utils.py)."""

import numpy as np
from scipy.spatial.distance import pdist

from timemachine_torch.fe.utils import get_romol_conf


def get_radius_of_mol_pair(mol_a, mol_b) -> float:
    """Half the largest distance between two atoms of the two molecules'
    conformers taken together."""
    conf = np.concatenate([get_romol_conf(mol_a), get_romol_conf(mol_b)])
    return 0.5 * float(pdist(conf).max())
