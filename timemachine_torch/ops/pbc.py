"""Periodic-boundary geometry, including the 4D "lifted" distance of
alchemical decoupling (counterpart of timemachine_tpu/ops/pbc.py).

Boxes are rectangular: only the diagonal of a (3, 3) box is used.
"""

from __future__ import annotations

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


def idxs_within_cutoff(x, x_lig, box, cutoff: float = 0.5):
    """Indices (numpy int64, ascending) of the rows of x within `cutoff` of
    any point of x_lig under the minimum image, as JAX's idxs_within_cutoff;
    host-side, its output's length depends on the data."""
    x, x_lig, box = (torch.as_tensor(a) for a in (x, x_lig, box))
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for point in x_lig:
        near |= distance(point, x, box) < cutoff
    return torch.nonzero(near).squeeze(1).cpu().numpy()


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
