"""Bonded (valence) terms: energies and closed-form forces
(counterpart of timemachine_tpu/ops/bonded.py).

Energies take (conf, params, box, idxs) and return a scalar in kJ/mol. The
`*_force_contribs` functions return (u, per-role force contributions): one
(T, 3) tensor per atom role of the term, each the force (-dU/dx) the term
puts on that atom. Callers sum them per atom with `ops.segment.SegmentSum`.
Index rows must be valid atom indices (no -1 padding rows in this port).
"""

from __future__ import annotations

import torch


def harmonic_bond(conf, params, box, idxs):
    """U = sum k/2 (|ri - rj| - r0)^2, params rows (k, r0); r0 == 0 rows use
    k/2 d^2. Not periodic: bonds never cross the box."""
    u, _ = bond_force_contribs(conf, params, idxs)
    return u


def stable_angle(ci, cj, ck, eps):
    """Angle at j between j->i and j->k in the half-angle (Kahan) form
    2 atan2(|n_jk r_ji - n_ji r_jk|, |n_jk r_ji + n_ji r_jk|), with eps
    appended as a fourth vector component so the angle stays defined when a
    bond vector collapses."""
    e = eps[..., None]
    rji = torch.cat([ci - cj, e], dim=-1)
    rjk = torch.cat([ck - cj, e], dim=-1)
    nji = torch.linalg.vector_norm(rji, dim=-1, keepdim=True)
    njk = torch.linalg.vector_norm(rjk, dim=-1, keepdim=True)
    y = torch.linalg.vector_norm(njk * rji - nji * rjk, dim=-1)
    x = torch.linalg.vector_norm(njk * rji + nji * rjk, dim=-1)
    return 2.0 * torch.atan2(y, x)


def harmonic_angle(conf, params, box, idxs):
    """U = sum k/2 (theta - theta0)^2, params rows (k, theta0, eps), theta
    from `stable_angle`."""
    theta = stable_angle(conf[idxs[:, 0]], conf[idxs[:, 1]], conf[idxs[:, 2]], params[:, 2])
    return torch.sum(0.5 * params[:, 0] * (theta - params[:, 1]) ** 2)


def signed_torsion_angle(ci, cj, ck, cl):
    """Signed dihedral i-j-k-l in the atan2 form."""
    rij = cj - ci
    rkj = cj - ck
    rkl = cl - ck
    n1 = torch.linalg.cross(rij, rkj)
    n2 = torch.linalg.cross(rkj, rkl)
    rkj_unit = rkj / torch.linalg.vector_norm(rkj, dim=-1, keepdim=True)
    y = torch.sum(torch.linalg.cross(n1, n2) * rkj_unit, dim=-1)
    x = torch.sum(n1 * n2, dim=-1)
    return torch.atan2(y, x)


def periodic_torsion(conf, params, box, idxs):
    """U = sum k (1 + cos(n phi - phase)), params rows (k, phase, n)."""
    c = conf[:, :3]
    phi = signed_torsion_angle(c[idxs[:, 0]], c[idxs[:, 1]], c[idxs[:, 2]], c[idxs[:, 3]])
    return torch.sum(params[:, 0] * (1.0 + torch.cos(params[:, 2] * phi - params[:, 1])))


def bond_force_contribs(conf, params, idxs):
    """(u, [f_i, f_j]) of harmonic bonds."""
    dx = conf[idxs[:, 0]] - conf[idxs[:, 1]]
    d2 = torch.sum(dx * dx, dim=-1)
    d = torch.sqrt(d2)
    k, r0 = params[:, 0], params[:, 1]
    u = torch.sum(torch.where(r0 == 0, 0.5 * k * d2, 0.5 * k * (d - r0) ** 2))
    # dU/d(ci) = pref * dx with pref = k (r0 == 0) else k (d - r0) / d
    pref = torch.where(r0 == 0, k, k * (d - r0) / torch.where(d > 0, d, 1.0))
    g = pref[:, None] * dx
    return u, [-g, g]


def angle_force_contribs(conf, params, idxs):
    """(u, [f_i, f_j, f_k]) of harmonic angles, eps stabilizer included: the
    Kahan form equals arccos of the eps-extended vectors (d, eps), whose
    gradient in the 3D components is closed-form."""
    ci, cj, ck = conf[idxs[:, 0]], conf[idxs[:, 1]], conf[idxs[:, 2]]
    d1 = ci - cj
    d2v = ck - cj
    k, a0, eps = params[:, 0], params[:, 1], params[:, 2]
    eps2 = eps * eps
    r1 = torch.sqrt(torch.clamp(torch.sum(d1 * d1, dim=1) + eps2, min=1e-24))
    r2 = torch.sqrt(torch.clamp(torch.sum(d2v * d2v, dim=1) + eps2, min=1e-24))
    c = torch.clamp((torch.sum(d1 * d2v, dim=1) + eps2) / (r1 * r2), -1.0 + 1e-7, 1.0 - 1e-7)
    s_inv = (1.0 - c * c) ** -0.5
    delta = torch.arccos(c) - a0
    u = torch.sum(0.5 * k * delta * delta)
    # dtheta/d(d1) = -s_inv (d2/(r1 r2) - c d1/r1^2); force = -k delta dtheta
    g = (k * delta * s_inv)[:, None]
    f_i = g * (d2v / (r1 * r2)[:, None] - c[:, None] * d1 / (r1 * r1)[:, None])
    f_k = g * (d1 / (r1 * r2)[:, None] - c[:, None] * d2v / (r2 * r2)[:, None])
    return u, [f_i, -(f_i + f_k), f_k]


def torsion_force_contribs(conf, params, idxs):
    """(u, [f_i, f_j, f_k, f_l]) of periodic torsions, by the Blondel-Karplus
    dihedral gradient in this module's `signed_torsion_angle` convention;
    collinear near-singularities are clamped."""
    c = conf[:, :3]
    ci, cj, ck, cl = c[idxs[:, 0]], c[idxs[:, 1]], c[idxs[:, 2]], c[idxs[:, 3]]
    rij = cj - ci
    rkj = cj - ck
    rkl = cl - ck
    n1 = torch.linalg.cross(rij, rkj)
    n2 = torch.linalg.cross(rkj, rkl)
    rkj2 = torch.sum(rkj * rkj, dim=-1)
    rkj_norm = torch.sqrt(torch.clamp(rkj2, min=1e-24))
    y = torch.sum(torch.linalg.cross(n1, n2) * rkj, dim=-1) / rkj_norm
    x = torch.sum(n1 * n2, dim=-1)
    phi = torch.atan2(y, x)
    k, phase, period = params[:, 0], params[:, 1], params[:, 2]
    u = torch.sum(k * (1.0 + torch.cos(period * phi - phase)))

    dU = -k * period * torch.sin(period * phi - phase)  # dU/dphi
    n1_2 = torch.clamp(torch.sum(n1 * n1, dim=-1), min=1e-18)
    n2_2 = torch.clamp(torch.sum(n2 * n2, dim=-1), min=1e-18)
    # phi == -phi_std (b2 = rk - rj = -rkj; m_std = -n1, n_std = -n2), so
    # F = +dU/dphi * dphi_std/dr with dphi_std/dri = |rkj| n1/|n1|^2 and
    # dphi_std/drl = -|rkj| n2/|n2|^2
    gi = (rkj_norm / n1_2)[:, None] * n1
    gl = -(rkj_norm / n2_2)[:, None] * n2
    rkj2_safe = torch.clamp(rkj2, min=1e-24)
    t = -(torch.sum(rij * rkj, dim=-1) / rkj2_safe)
    s = -(torch.sum(rkl * rkj, dim=-1) / rkj2_safe)
    gj = -(t + 1.0)[:, None] * gi + s[:, None] * gl
    gk = t[:, None] * gi - (s + 1.0)[:, None] * gl
    w = dU[:, None]
    return u, [w * gi, w * gj, w * gk, w * gl]
