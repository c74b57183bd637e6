"""Hydrogen mass repartitioning (same rule as timemachine_tpu/fe/model_utils.py)."""

from __future__ import annotations

import numpy as np


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
