"""Rigid alignment (Kabsch) and RMSD-based restraints (the port of
timemachine_tpu/ops/rmsd.py).

Every function takes torch tensors (numpy arrays are taken as CPU tensors)
with any leading batch axes before the (N, 3) coordinates, so the aligned
proposals of md/enhanced.py align K conformers in one call. The rotation
comes from torch.linalg.svd with the reflection flip; where the SVD's signs
differ from another library's, u diag(1, 1, d) vh is the same rotation
unless two singular values coincide.
"""

from __future__ import annotations

import torch


def get_optimal_rotation(x1, x2):
    """Rotation R minimizing ||x1 - x2 @ R|| for centered x1, x2 (Kabsch with
    the reflection correction)."""
    x1, x2 = torch.as_tensor(x1), torch.as_tensor(x2)
    correlation = x2.mT @ x1
    u, _, vh = torch.linalg.svd(correlation, full_matrices=False)
    d = torch.sign(torch.linalg.det(u @ vh))
    ones = torch.ones_like(d)
    flip = torch.diag_embed(torch.stack([ones, ones, d], dim=-1))
    return u @ flip @ vh


def get_optimal_translation(x1, x2):
    """Translation moving x2's centroid onto x1's."""
    return torch.as_tensor(x1).mean(-2) - torch.as_tensor(x2).mean(-2)


def get_optimal_rotation_and_translation(x1, x2):
    """(R, t) minimizing RMSD(x1, x2 @ R + t)."""
    x1, x2 = torch.as_tensor(x1), torch.as_tensor(x2)
    t = get_optimal_translation(x1, x2)
    x1_c = x1 - x1.mean(-2, keepdim=True)
    x2_c = x2 - x2.mean(-2, keepdim=True)
    return get_optimal_rotation(x1_c, x2_c), t


def apply_rotation_and_translation(x, R, t):
    """Rotate about x's centroid, then translate."""
    x = torch.as_tensor(x)
    centroid = x.mean(-2, keepdim=True)
    return (x - centroid) @ R + centroid + t.unsqueeze(-2)


def align_x2_unto_x1(x1, x2):
    """x2 rigidly moved to be maximally aligned with x1."""
    R, t = get_optimal_rotation_and_translation(x1, x2)
    return apply_rotation_and_translation(x2, R, t)


def rmsd_align(x1, x2):
    """Both conformers centered and x2 rotated onto x1: (x1', x2')."""
    x1, x2 = torch.as_tensor(x1), torch.as_tensor(x2)
    x1_c = x1 - x1.mean(-2, keepdim=True)
    x2_c = x2 - x2.mean(-2, keepdim=True)
    return x1_c, x2_c @ get_optimal_rotation(x1_c, x2_c)


def psi(rotation, k):
    """Restraint energy of a rotation matrix, k (1 - cos θ), θ its angle."""
    cos_theta = (torch.diagonal(torch.as_tensor(rotation), dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return k * (1.0 - cos_theta)


def rmsd_restraint(conf, params, box, group_a_idxs, group_b_idxs, k):
    """Restraint on the residual rigid rotation between two atom groups;
    translation-invariant: only the optimal rotation's angle is penalized."""
    del params, box
    conf = torch.as_tensor(conf)
    x_a = conf[..., torch.as_tensor(group_a_idxs), :]
    x_b = conf[..., torch.as_tensor(group_b_idxs), :]
    x_a_c = x_a - x_a.mean(-2, keepdim=True)
    x_b_c = x_b - x_b.mean(-2, keepdim=True)
    return psi(get_optimal_rotation(x_a_c, x_b_c), k)
