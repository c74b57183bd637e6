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
