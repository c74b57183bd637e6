"""Core-restraint atom mapping from a SMARTS core (counterpart of
timemachine_tpu/fe/restraints.py).

Every embedding of the core in each molecule is a candidate labelling.
Each pair of labellings is scored by the RMSD of the minimum-cost
assignment (scipy's linear_sum_assignment, the Hungarian algorithm) between
their coordinates, and the best-scoring pair wins. The mapping returned is
positional: core atom k of one embedding against core atom k of the other.
"""

from itertools import product

import numpy as np
from scipy.optimize import linear_sum_assignment

from timemachine_torch.chem.smarts import match_smarts
from timemachine_torch.fe.utils import get_romol_conf

MAX_MATCHES = 1000


def _hungarian_pairing(pa, pb):
    """(RMSD of the assignment, rows, cols) between two (K, 3) coordinate sets."""
    d = np.linalg.norm(pa[:, None, :] - pb[None, :, :], axis=-1)
    rows, cols = linear_sum_assignment(d)
    return float(np.linalg.norm(pa[rows] - pb[cols])), rows, cols


def setup_relative_restraints_using_smarts(mol_a, mol_b, smarts):
    """(N, 2) int32 atom mapping between mol_a and mol_b over a connected core SMARTS."""
    if "." in smarts:
        raise AssertionError("restraint core SMARTS must be connected (no '.')")

    matches_a = np.array(match_smarts(mol_a, smarts, uniquify=False))
    matches_b = np.array(match_smarts(mol_b, smarts, uniquify=False))
    assert 0 < len(matches_a) < MAX_MATCHES, "SMARTS core must match mol_a"
    assert 0 < len(matches_b) < MAX_MATCHES, "SMARTS core must match mol_b"

    xa = get_romol_conf(mol_a)
    xb = get_romol_conf(mol_b)
    scored = ((_hungarian_pairing(xa[ca], xb[cb])[0], ca, cb) for ca, cb in product(matches_a, matches_b))
    best_rmsd, ca, cb = min(scored, key=lambda t: t[0])
    core_idxs = np.stack([ca, cb], axis=1).astype(np.int32)
    print("core_idxs", core_idxs, "rmsd", best_rmsd)
    return core_idxs
