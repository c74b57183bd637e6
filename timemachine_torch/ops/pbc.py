"""Periodic-boundary geometry, including the 4D "lifted" distance of
alchemical decoupling (counterpart of timemachine_tpu/ops/pbc.py).

Boxes are rectangular: only the diagonal of a (3, 3) box is used.
"""

from __future__ import annotations

import numpy as np
import torch


def periodic_delta(ri, rj, box=None):
    """Minimum-image displacement ri - rj; box=None means vacuum."""
    diff = ri - rj
    if box is not None:
        box_diag = torch.diagonal(box, dim1=-2, dim2=-1)
        diff = diff - box_diag * torch.floor(diff / box_diag + 0.5)
    return diff


def distance_sq(ri, rj, box=None):
    d = periodic_delta(ri, rj, box)
    return torch.sum(d * d, dim=-1)


def distance(ri, rj, box=None):
    return torch.sqrt(distance_sq(ri, rj, box))


def lifted_distance_on_pairs(ri, rj, box=None, w_offsets=None):
    """Per-pair distance sqrt(|dr_3d|^2 + dw^2), with w the aperiodic
    alchemical coordinate; coincident points give 0."""
    d2 = distance_sq(ri, rj, box)
    if w_offsets is not None:
        d2 = d2 + w_offsets * w_offsets
    return torch.sqrt(d2)


def pairwise_distance_matrix(x, box=None, w=None):
    """(N, N) periodic distances, lifted into 4D by w when given; the
    diagonal and coincident points are exactly 0."""
    n = x.shape[0]
    d2 = distance_sq(x[:, None, :], x[None, :, :], box)
    if w is not None:
        dw = w[:, None] - w[None, :]
        d2 = d2 + dw * dw
    d2 = d2.masked_fill(torch.eye(n, dtype=torch.bool, device=x.device), 0.0)
    return torch.sqrt(d2)


def distances_from_point(x_i, x_others, box=None, cutoff=float("inf")):
    """Distances from one point to a set; entries beyond cutoff become +inf."""
    d2 = distance_sq(x_i, x_others, box)
    return torch.where(d2 <= cutoff**2, torch.sqrt(d2), torch.inf)


def idxs_within_cutoff(x, x_lig, box, cutoff: float = 0.5):
    """Indices (numpy int64, ascending) of the rows of x within `cutoff` of
    any point of x_lig under the minimum image, as JAX's idxs_within_cutoff;
    host-side, its output's length depends on the data."""
    x, x_lig, box = (torch.as_tensor(a) for a in (x, x_lig, box))
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for point in x_lig:
        near |= distance(point, x, box) < cutoff
    return torch.nonzero(near).squeeze(1).cpu().numpy()


def all_pairs_idxs(n: int) -> np.ndarray:
    """All (i, j) with i < j, host-side."""
    return np.stack(np.triu_indices(n, k=1)).T.astype(np.int32)


def interaction_group_idxs(group_a, group_b) -> np.ndarray:
    """Cartesian product pairs (a, b), host-side."""
    a = np.asarray(group_a)
    b = np.asarray(group_b)
    pairs = np.stack(np.meshgrid(a, b, indexing="ij")).reshape(2, -1).T
    return pairs.astype(np.int32)


def image_molecules(x, box, mol_groups):
    """Each molecule (mol_groups: index arrays) shifted by box vectors so its
    centroid lies in the home box; numpy in and out, for writing frames."""
    import numpy as np

    x = np.asarray(x)
    box_diag = np.diagonal(box)
    out = x.copy()
    for idxs in mol_groups:
        centroid = x[idxs].mean(axis=0)
        out[idxs] = x[idxs] - box_diag * np.floor(centroid / box_diag)
    return out
