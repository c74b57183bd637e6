"""Bonded (valence) terms: energies and closed-form forces
(counterpart of timemachine_tpu/ops/bonded.py).

Energies take (conf, params, box, idxs) and return a scalar in kJ/mol. The
`*_force_contribs` functions return (u, per-role force contributions): one
(T, 3) tensor per atom role of the term, each the force (-dU/dx) the term
puts on that atom. Callers sum them per atom with `ops.segment.SegmentSum`
or one shared plan (`ops.assembly`). Index rows must be valid atom indices
(no -1 padding rows in this port).

Leading TIP3P waters (atoms 3w..3w+2, the builders' layout) have strided
paths (`water_bond_energy_force`, `water_angle_energy_force`): the force is
assembled by a reshape, with no index gather and no segment sum.
"""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch.constants import DEFAULT_POSITIONAL_RESTRAINT_K
from timemachine_torch.ops.pbc import periodic_delta


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


# The strided water paths are on, as in the JAX package (its default).
WATER_FAST_PATH = True


def _leading_water_bonds(bond_idxs) -> int:
    """Number of leading waters whose O-H bonds are rows 2w, 2w+1 =
    (3w, 3w+1), (3w, 3w+2), the builders' layout (host-side)."""
    if not WATER_FAST_PATH:
        return 0
    idxs = np.asarray(bond_idxs)
    if idxs.ndim != 2 or idxs.shape[0] < 2:
        return 0
    w = np.arange(idxs.shape[0] // 2)
    ok = (
        (idxs[2 * w, 0] == 3 * w)
        & (idxs[2 * w, 1] == 3 * w + 1)
        & (idxs[2 * w + 1, 0] == 3 * w)
        & (idxs[2 * w + 1, 1] == 3 * w + 2)
    )
    bad = np.nonzero(~ok)[0]
    return int(bad[0]) if bad.size else w.size


def _leading_water_angles(angle_idxs) -> int:
    """Number of leading waters whose H-O-H angle is row w = (3w+1, 3w,
    3w+2), the builders' layout (host-side)."""
    if not WATER_FAST_PATH:
        return 0
    idxs = np.asarray(angle_idxs)
    if idxs.ndim != 2 or idxs.shape[0] < 1:
        return 0
    w = np.arange(idxs.shape[0])
    ok = (idxs[:, 0] == 3 * w + 1) & (idxs[:, 1] == 3 * w) & (idxs[:, 2] == 3 * w + 2)
    bad = np.nonzero(~ok)[0]
    return int(bad[0]) if bad.size else w.size


def _water_force(conf, f_o, f_h1, f_h2):
    """(N, 3) force: the first nw waters' per-atom forces laid out by a
    reshape (water w is atoms 3w..3w+2), zero elsewhere."""
    nw = f_o.shape[0]
    force_w = torch.stack([f_o, f_h1, f_h2], dim=1).reshape(3 * nw, 3)
    return torch.cat([force_w, conf.new_zeros((conf.shape[0] - 3 * nw, 3))])


def water_bond_energy_force(conf, params, nw: int):
    """(u, force) of the first nw waters' O-H bonds (params rows 2w, 2w+1),
    in closed form on the (nw, 3, 3) reshape of their coordinates."""
    x = conf[: 3 * nw].reshape(nw, 3, 3)  # (water, atom {O, H1, H2}, xyz)
    o = x[:, 0]
    u = conf.new_zeros(())
    f_o = torch.zeros_like(o)
    f_h = []
    for h, row in ((1, 0), (2, 1)):
        d = x[:, h] - o
        r = torch.sqrt(torch.clamp(torch.sum(d * d, dim=1), min=1e-24))
        k, r0 = params[row : 2 * nw : 2, 0], params[row : 2 * nw : 2, 1]
        delta = r - r0
        u = u + torch.sum(0.5 * k * delta * delta)
        pref = (k * delta / r)[:, None]  # dU/dr / r
        f_h.append(-pref * d)
        f_o = f_o + pref * d
    return u, _water_force(conf, f_o, *f_h)


def water_angle_energy_force(conf, params, nw: int):
    """(u, force) of the first nw waters' H-O-H angles (params rows w) in
    the arccos form, clipped at 1 -+ 1e-7: `stable_angle` at eps = 0, which
    the water rows carry; it agrees with the generic path away from the
    clip, and H-O-H never nears it."""
    x = conf[: 3 * nw].reshape(nw, 3, 3)
    o, h1, h2 = x[:, 0], x[:, 1], x[:, 2]
    d1, d2 = h1 - o, h2 - o
    r1 = torch.sqrt(torch.clamp(torch.sum(d1 * d1, dim=1), min=1e-24))
    r2 = torch.sqrt(torch.clamp(torch.sum(d2 * d2, dim=1), min=1e-24))
    u1, u2 = d1 / r1[:, None], d2 / r2[:, None]
    c = torch.clamp(torch.sum(u1 * u2, dim=1), -1.0 + 1e-7, 1.0 - 1e-7)
    s_inv = (1.0 - c * c) ** -0.5
    k, a0 = params[:nw, 0], params[:nw, 1]
    delta = torch.arccos(c) - a0
    u = torch.sum(0.5 * k * delta * delta)
    # dtheta/d(d1) = (c u1 - u2) s_inv / r1; force = -k delta dtheta/dx
    g = (k * delta * s_inv)[:, None]
    f_h1 = -g * (c[:, None] * u1 - u2) / r1[:, None]
    f_h2 = -g * (c[:, None] * u2 - u1) / r2[:, None]
    return u, _water_force(conf, -(f_h1 + f_h2), f_h1, f_h2)


def _assembled(conf, idxs, contribs, assemble, width: int = 3):
    """The (N, 3) sum of per-role contributions onto their atoms by a
    fixed-order SegmentSum over the role-major atoms of idxs (built here
    when not given), widened with zero columns to conf's width."""
    if assemble is None:
        from timemachine_torch.ops.segment import SegmentSum

        assemble = SegmentSum(np.asarray(idxs.cpu() if torch.is_tensor(idxs) else idxs).T.ravel(), conf.shape[0],
                              device=conf.device)
    force = assemble(torch.cat(contribs))
    if conf.shape[1] > width:
        force = torch.cat([force, conf.new_zeros((conf.shape[0], conf.shape[1] - width))], dim=1)
    return force


def generic_bond_energy_force(conf, params, box, idxs, assemble=None):
    """(u, force) of arbitrary harmonic-bond rows: bond_force_contribs summed
    onto atoms by a fixed-order SegmentSum (`assemble`, over cat([idxs[:, 0],
    idxs[:, 1]]); built here when None), not a scatter."""
    u, contribs = bond_force_contribs(conf, params, idxs)
    return u, _assembled(conf, idxs, contribs, assemble, conf.shape[1])


def generic_angle_energy_force(conf, params, box, idxs, assemble=None):
    """(u, force) of harmonic-angle rows, eps stabilizer included
    (angle_force_contribs), summed as generic_bond_energy_force's."""
    u, contribs = angle_force_contribs(conf, params, idxs)
    return u, _assembled(conf, idxs, contribs, assemble, conf.shape[1])


def torsion_energy_force(conf, params, box, idxs, assemble=None):
    """(u, force) of periodic-torsion rows (torsion_force_contribs), summed
    as generic_bond_energy_force's; columns of conf past the third get zero
    force."""
    u, contribs = torsion_force_contribs(conf, params, idxs)
    return u, _assembled(conf, idxs, contribs, assemble)


def harmonic_positional_restraint(x_init, x_new, box, k: float = DEFAULT_POSITIONAL_RESTRAINT_K):
    """k/2 sum |x_new - x_init|^2 under the minimum image: the tether of a
    restrained minimization."""
    d = periodic_delta(x_new, x_init, box)
    return torch.sum(0.5 * k * torch.sum(d * d, dim=-1))


def _flat_bottom_terms(conf, params, box, idxs):
    """(per-pair U, dU/dr, minimum-image ri - rj, r) of the quartic flat
    bottom: U = k/4 (r - r_max)^4 beyond r_max, k/4 (r - r_min)^4 below
    r_min, 0 between; params rows (k, r_min, r_max)."""
    d = periodic_delta(conf[idxs[:, 0]], conf[idxs[:, 1]], box)
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    k, r_min, r_max = params[:, 0], params[:, 1], params[:, 2]
    over = torch.where(r > r_max, r - r_max, 0.0)
    under = torch.where(r < r_min, r - r_min, 0.0)
    return 0.25 * k * (over**4 + under**4), k * (over**3 + under**3), d, r


def _pair_contribs(du_dr, d, r):
    """[f_i, f_j] of pair energies with dU/dr along the minimum-image d = ri - rj."""
    g = (du_dr / torch.where(r > 0, r, 1.0))[:, None] * d
    return [-g, g]


def flat_bottom_bond(conf, params, box, idxs):
    """U = sum of the quartic flat bottoms (periodic)."""
    return flat_bottom_force_contribs(conf, params, box, idxs)[0]


def flat_bottom_force_contribs(conf, params, box, idxs):
    """(u, [f_i, f_j]) of flat-bottom bonds."""
    u, du_dr, d, r = _flat_bottom_terms(conf, params, box, idxs)
    return torch.sum(u), _pair_contribs(du_dr, d, r)


def log_flat_bottom_bond(conf, params, box, idxs, beta: float):
    """U = -1/beta sum log(1 - exp(-beta U_fb)): the log-complement flat
    bottom of local MD's selection; +inf where a U_fb is 0."""
    return log_flat_bottom_force_contribs(conf, params, box, idxs, beta)[0]


def log_flat_bottom_force_contribs(conf, params, box, idxs, beta: float):
    """(u, [f_i, f_j]) of log-complement flat-bottom bonds."""
    u_fb, du_dr, d, r = _flat_bottom_terms(conf, params, box, idxs)
    e = torch.exp(-beta * u_fb)
    u = torch.sum(-torch.log(1.0 - e)) / beta
    return u, _pair_contribs(-e / (1.0 - e) * du_dr, d, r)


def centroid_restraint_contribs(conf, group_a_idxs, group_b_idxs, kb: float, b0: float):
    """(u, [f_a, f_b]) of U = kb (|c_a - c_b| - b0)^2 between the groups'
    geometric centroids, or kb |c_a - c_b|^2 where b0 == 0: f_a (A, 3) the
    force on each atom of group a, f_b (B, 3) on each of group b. At
    coincident centroids the force is 0 and U = kb b0^2, as JAX's guarded
    sqrt gives."""
    dx = torch.mean(conf[group_a_idxs], dim=0) - torch.mean(conf[group_b_idxs], dim=0)
    d2 = torch.sum(dx * dx)
    safe_d = torch.sqrt(torch.where(d2 > 0, d2, 1.0))
    if b0 == 0:
        u, du_ddx = kb * d2, 2.0 * kb * dx
    else:
        d = torch.where(d2 > 0, safe_d, 0.0)
        u = kb * (d - b0) ** 2
        du_ddx = torch.where(d2 > 0, 2.0 * kb * (d - b0) / safe_d, 0.0) * dx
    f_a = (-du_ddx / len(group_a_idxs)).expand(len(group_a_idxs), 3)
    f_b = (du_ddx / len(group_b_idxs)).expand(len(group_b_idxs), 3)
    return u, [f_a, f_b]


def centroid_restraint(conf, params, box, group_a_idxs, group_b_idxs, kb: float, b0: float):
    """U = kb (|c_a - c_b| - b0)^2 between geometric centroids (the b0 == 0
    form kb d^2 has no sqrt); params and box are unused, as in JAX's."""
    return centroid_restraint_contribs(conf, group_a_idxs, group_b_idxs, kb, b0)[0]
