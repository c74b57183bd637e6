"""Host-side MD helpers (numpy), same results as timemachine_tpu/md/utils.py."""

from __future__ import annotations

import numpy as np

from timemachine_torch.constants import BOLTZ


def compute_box_volume(box) -> float:
    assert box.shape == (3, 3)
    return float(np.linalg.det(box))


def compute_box_center(box) -> np.ndarray:
    box = np.asarray(box)
    assert box.shape == (3, 3)
    assert not np.any(box - np.diag(np.diagonal(box))), "expected an axis-aligned box"
    return 0.5 * np.diagonal(box).copy()


def get_bond_list(harmonic_bond_potential) -> list[tuple[int, int]]:
    """Topology read off a harmonic-bond potential's indices (every valence
    bond is assumed to be there)."""
    return [(int(i), int(j)) for i, j in harmonic_bond_potential.idxs]


def get_group_indices(bond_list, num_atoms: int) -> list[np.ndarray]:
    """Connected components of the bond graph over all atoms (unbonded atoms
    are singleton groups), each sorted ascending, components ordered by their
    smallest member."""
    root = np.arange(num_atoms, dtype=np.int64)

    def find(a: int) -> int:
        while root[a] != a:
            root[a] = root[root[a]]  # path halving
            a = root[a]
        return a

    for i, j in bond_list:
        if not (0 <= i < num_atoms and 0 <= j < num_atoms):
            raise ValueError(f"bond ({i}, {j}) out of range for {num_atoms} atoms")
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:  # union by smallest label keeps roots == component minima
            lo, hi = (ri, rj) if ri < rj else (rj, ri)
            root[hi] = lo

    labels = np.array([find(a) for a in range(num_atoms)])
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    starts = np.flatnonzero(np.r_[True, sorted_labels[1:] != sorted_labels[:-1]])
    return [np.array(chunk) for chunk in np.split(order, starts[1:])]


def compute_intramolecular_distances(coords, group_indices):
    """Condensed pairwise distances within each group."""
    from scipy.spatial.distance import pdist

    return [pdist(coords[inds]) for inds in group_indices]


def sample_velocities(masses, temperature: float, seed: int) -> np.ndarray:
    """Maxwell-Boltzmann draw at `temperature` (numpy generator from `seed`)."""
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(BOLTZ * temperature / np.asarray(masses, dtype=np.float64))
    return sigma[:, None] * rng.normal(size=(len(sigma), 3))
