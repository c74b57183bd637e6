"""Chirality-preserving flat-bottom restraints
(counterpart of timemachine_tpu/ops/chiral.py).

They keep stereocenters from inverting while the bonded terms are
interpolated across alchemical states. Energies take (conf, params, box,
idxs[, signs]); the box is unused. The `*_contribs` functions return (u,
per-role forces) in the form of ops/bonded.py, for a SegmentSum onto atoms:
each term's gradient is taken by torch.func.grad on its own four gathered
atoms, so nothing is scattered.
"""

from __future__ import annotations

import torch


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def pyramidal_volume(xc, x1, x2, x3):
    """Signed volume of the pyramid with apex xc: the triple product of the
    three unit vectors out of the center, in (-1, 1)."""
    v0, v1, v2 = _unit(x1 - xc), _unit(x2 - xc), _unit(x3 - xc)
    return torch.sum(torch.linalg.cross(v0, v1) * v2, dim=-1)


def torsion_volume(ci, cj, ck, cl):
    """Torsional volume: the dot product of the two unit-plane normals."""
    rij, rkj, rkl = _unit(cj - ci), _unit(cj - ck), _unit(cl - ck)
    n1 = torch.linalg.cross(rij, rkj)
    n2 = torch.linalg.cross(rkj, rkl)
    return torch.sum(n1 * n2, dim=-1)


def _atom_terms(x, params, signs=None):
    """Per-term U = k v^2 where v > 0, else 0; x (C, 4, 3) [center, a, b, c]."""
    v = pyramidal_volume(x[:, 0], x[:, 1], x[:, 2], x[:, 3])
    return torch.where(v > 0, params * v * v, 0.0)


def _bond_terms(x, params, signs):
    """Per-term U = k v^2 where v s > 0, else 0; x (C, 4, 3) a torsion's atoms."""
    v = torsion_volume(x[:, 0], x[:, 1], x[:, 2], x[:, 3])
    return torch.where(v * signs > 0, params * v * v, 0.0)


def chiral_atom_restraint(conf, params, box, idxs):
    """Sum of k v^2 over terms whose pyramidal volume v is positive; idxs
    (C, 4) [center, a, b, c], params (C,) force constants."""
    return torch.sum(_atom_terms(conf[idxs], params))


def chiral_bond_restraint(conf, params, box, idxs, signs):
    """Sum of k v^2 over terms whose torsion volume v has the sign of s;
    idxs (C, 4), params (C,), signs (C,) +-1."""
    return torch.sum(_bond_terms(conf[idxs], params, signs))


def _contribs(terms, conf, params, idxs, signs=None):
    if idxs.shape[0] == 0:
        return conf.new_zeros(()), [conf.new_zeros((0, 3))] * 4
    # torch.func rather than autograd.grad: the same gradient, and it runs
    # under torch.func.vmap over replicas (a batched step) and under no_grad
    g, u = torch.func.grad_and_value(lambda x: torch.sum(terms(x, params, signs)))(conf[idxs])
    return u, [-g[:, k] for k in range(4)]


def chiral_atom_contribs(conf, params, idxs):
    """(u, [f_center, f_a, f_b, f_c]) of chiral_atom_restraint."""
    return _contribs(_atom_terms, conf, params, idxs)


def chiral_bond_contribs(conf, params, idxs, signs):
    """(u, [f_i, f_j, f_k, f_l]) of chiral_bond_restraint."""
    return _contribs(_bond_terms, conf, params, idxs, signs)
