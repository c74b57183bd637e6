"""Nonbonded math: Lennard-Jones plus switched-erfc Coulomb in 4D
(counterpart of timemachine_tpu/ops/nonbonded.py).

Per-atom parameter rows are [q sqrt(138.935456), sigma/2, sqrt(eps), w]:
sigma_ij = s_i + s_j, eps_ij = e_i e_j, and the pair distance is
sqrt(|dr|^2 + (w_i - w_j)^2). The all-pairs term runs in the rowscan sweep
(ops/rowscan_kernel.py), the block-tile sweep (ops/nonbonded_kernel.py) or
the dense form here (`DenseAllPairs`, JAX's impl="dense": exact erfc, the
exclusions as (1 - scale) rescale masks, over Newton-triangular row blocks
so that no (N, N) array is held). This module also holds the exclusion
corrections of the swept forms, which evaluate the sweep's own
electrostatics so that they cancel it: the rowscan polynomial or exact
erfc, each in closed form.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from timemachine_torch.ops.pbc import periodic_delta

# the switch is pinned at 1.2 nm whatever the interaction cutoff
SWITCH_CUTOFF = 1.2


def polyval_t(t, coeffs):
    """Monomial series (python floats, low -> high) at t by Horner."""
    acc = torch.full_like(t, coeffs[-1])
    for ck in coeffs[-2::-1]:
        acc.mul_(t).add_(ck)  # in place on the fresh accumulator: no temporaries
    return acc


def switch_fn(dij):
    """cos^3((pi/2)(d/c)^8) for d < c, else 0, with c = SWITCH_CUTOFF."""
    f = torch.cos(0.5 * math.pi * (dij / SWITCH_CUTOFF) ** 8) ** 3
    return torch.where(dij < SWITCH_CUTOFF, f, 0.0)


def combine_sigma(sig_half_i, sig_half_j):
    return sig_half_i + sig_half_j


def combine_epsilon(sqrt_eps_i, sqrt_eps_j):
    return sqrt_eps_i * sqrt_eps_j


def lennard_jones(dij, sig_ij, eps_ij):
    sig6 = (sig_ij / dij) ** 6
    return 4.0 * eps_ij * (sig6 * sig6 - sig6)


def direct_space_pme(dij, qij, beta):
    """q_ij erfc(beta d) / d, the real-space Ewald term."""
    return qij * torch.special.erfc(beta * dij) / dij


def validate_coulomb_cutoff(cutoff=1.0, beta=2.0, threshold=1e-2):
    import warnings

    tail = float(math.erfc(beta * cutoff))
    if tail > threshold:
        warnings.warn(f"erfc(beta * cutoff) = {tail} > threshold = {threshold}")


def exclusions_to_rescale_masks(exclusion_idxs, scale_factors, n):
    """Dense (N, N) multiplicative masks from the exclusion list, 1 - scale:
    column 0 of scale_factors scales charge, column 1 LJ. Host-side."""
    charge_mask = np.ones((n, n))
    lj_mask = np.ones((n, n))
    for (i, j), (q_scale, lj_scale) in zip(np.asarray(exclusion_idxs), np.asarray(scale_factors)):
        charge_mask[i, j] = charge_mask[j, i] = 1.0 - q_scale
        lj_mask[i, j] = lj_mask[j, i] = 1.0 - lj_scale
    return charge_mask, lj_mask


def filter_exclusions(atom_idxs, exclusion_idxs, scale_factors, update_idxs=False):
    """Drop exclusions touching atoms outside atom_idxs; with update_idxs,
    renumber the rest into atom_idxs' order. Host-side."""
    keep = set(int(a) for a in atom_idxs)
    remap = {int(j): i for i, j in enumerate(atom_idxs)}
    out_idxs, out_scales = [], []
    for (i, j), sf in zip(np.asarray(exclusion_idxs), np.asarray(scale_factors)):
        i, j = int(i), int(j)
        if i not in keep or j not in keep:
            continue
        if update_idxs:
            i, j = remap[i], remap[j]
        out_idxs.append((i, j))
        out_scales.append(sf)
    out_idxs_arr = np.array(out_idxs, dtype=np.int32).reshape(-1, 2)
    n_cols = np.asarray(scale_factors).reshape(len(scale_factors), -1).shape[1] if len(scale_factors) else 2
    out_scales_arr = np.array(out_scales, dtype=np.float64).reshape(-1, n_cols)
    return out_idxs_arr, out_scales_arr


def validate_interaction_group_idxs(n_atoms, a_idxs, b_idxs):
    a, b = set(map(int, a_idxs)), set(map(int, b_idxs))
    ab = a | b
    assert a.isdisjoint(b)
    assert max(ab) < n_atoms and min(ab) >= 0
    assert len(a_idxs) == len(a) and len(b_idxs) == len(b)


def switched_direct_space_pme(dij, qij, beta):
    return qij * torch.special.erfc(beta * dij) / dij * switch_fn(dij)


def _poly_pair_grad(d, dw, qij, sig_ij, eps_ij, cutoff, h_coeffs):
    """Energies and gradient vectors of explicit pairs with polynomial
    electrostatics: returns (u per pair, dU/d(x_l) per pair). Pairs at or
    beyond the cutoff contribute nothing; eps_ij and qij carry the pair
    scales."""
    d2 = torch.sum(d * d, dim=-1) + dw * dw
    dij = torch.sqrt(d2)
    keep = (d2 > 0) & (dij < cutoff)
    dij_safe = torch.where(keep, dij, 1.0)
    inv_d = 1.0 / dij_safe
    eps_eff = torch.where(keep, eps_ij, 0.0)
    sig6 = torch.where(eps_eff != 0, (sig_ij * inv_d) ** 6, 0.0)
    u_lj = 4.0 * eps_eff * (sig6 * sig6 - sig6)
    du_lj = 4.0 * eps_eff * inv_d * (6.0 * sig6 - 12.0 * sig6 * sig6)  # d(u_lj)/dd
    q_eff = torch.where(keep, qij, 0.0)
    t = 2.0 * (dij_safe / SWITCH_CUTOFF) - 1.0
    h = polyval_t(t, h_coeffs)
    hp = polyval_t(t, _poly_derivative(h_coeffs))
    u_es = q_eff * h * inv_d
    du_es = q_eff * (hp * (2.0 / SWITCH_CUTOFF) * inv_d - h * inv_d * inv_d)  # d(u_es)/dd
    g = ((du_lj + du_es) * inv_d)[:, None] * d
    return u_lj + u_es, g


@functools.lru_cache(maxsize=8)
def _poly_derivative(coeffs):
    return tuple(float(c) for c in np.polynomial.polynomial.polyder(np.asarray(coeffs)))


def specific_pairs_force_contribs(conf, params, box, pairs, beta, cutoff, rescale_mask, es_poly_coeffs):
    """(u, [f_l, f_r]) of an explicit pair list with polynomial
    electrostatics: u the sum of scaled pair energies, f_l and f_r (P, 3) the
    force (-dU/dx) each pair puts on its first and second atom, zero at or
    beyond the cutoff. rescale_mask (P, 2) holds [q_scale, lj_scale]; beta
    is unused (the series holds it), as in JAX's. Shared by
    specific_pairs_energy_force and the Context's contribution plan."""
    l, r = pairs[:, 0], pairs[:, 1]
    q, sig, eps, w = params.unbind(1)
    d = periodic_delta(conf[l], conf[r], box)
    u, g = _poly_pair_grad(
        d, w[l] - w[r], q[l] * q[r] * rescale_mask[:, 0], combine_sigma(sig[l], sig[r]),
        combine_epsilon(eps[l], eps[r]) * rescale_mask[:, 1], cutoff, es_poly_coeffs,
    )
    return torch.sum(u), [-g, g]


def specific_pairs_energy_force(conf, params, box, pairs, cutoff, rescale_mask, h_coeffs, assemble):
    """(u, force) of an explicit pair list with polynomial electrostatics
    (specific_pairs_force_contribs), force = -dU/dx summed onto atoms by
    `assemble`, a SegmentSum over cat([pairs[:, 0], pairs[:, 1]])."""
    u, contribs = specific_pairs_force_contribs(conf, params, box, pairs, None, cutoff, rescale_mask, h_coeffs)
    return u, assemble(torch.cat(contribs))


def leading_water_exclusions(exc_idxs, exc_scales) -> int:
    """Number of leading TIP3P waters whose exclusions appear as rows
    [3w, 3w+1, 3w+2] = [(3w,3w+1), (3w,3w+2), (3w+1,3w+2)] with full [1, 1]
    scales (host-side). Their correction runs on strided slices, with no
    gather or scatter."""
    exc_idxs = np.asarray(exc_idxs)
    exc_scales = np.asarray(exc_scales)
    if exc_idxs.ndim != 2 or exc_idxs.shape[0] < 3:
        return 0
    nw = exc_idxs.shape[0] // 3
    w = np.arange(nw)
    ok = (
        (exc_idxs[3 * w, 0] == 3 * w)
        & (exc_idxs[3 * w, 1] == 3 * w + 1)
        & (exc_idxs[3 * w + 1, 0] == 3 * w)
        & (exc_idxs[3 * w + 1, 1] == 3 * w + 2)
        & (exc_idxs[3 * w + 2, 0] == 3 * w + 1)
        & (exc_idxs[3 * w + 2, 1] == 3 * w + 2)
        & np.all(exc_scales[3 * w] == 1.0, axis=-1)
        & np.all(exc_scales[3 * w + 1] == 1.0, axis=-1)
        & np.all(exc_scales[3 * w + 2] == 1.0, axis=-1)
    )
    bad = np.nonzero(~ok)[0]
    return int(bad[0]) if bad.size else nw


def _exact_pair_energy(d, dw, qij, sig_ij, eps_ij, beta, cutoff):
    """(vdW, es) per pair with exact erfc electrostatics, as the JAX
    package's nonbonded_on_specific_pairs without a polynomial: pairs at or
    beyond the cutoff give 0, coincident points give finite zeros."""
    d2 = torch.sum(d * d, dim=-1) + dw * dw
    dij = torch.where(d2 > 0, torch.sqrt(torch.where(d2 > 0, d2, 1.0)), 0.0)  # finite gradient at d2 = 0
    keep = dij < cutoff
    dij_safe = torch.where(dij > 0, dij, 1.0)
    sig_ij = torch.where(keep, sig_ij, 0.0)
    eps_ij = torch.where(keep, eps_ij, 0.0)
    vdw = torch.where(eps_ij != 0, lennard_jones(dij_safe, sig_ij, eps_ij), 0.0)
    es = torch.where(keep, switched_direct_space_pme(dij_safe, torch.where(keep, qij, 0.0), beta), 0.0)
    return vdw, es


def nonbonded_on_specific_pairs(conf, params, box, pairs, beta, cutoff, rescale_mask):
    """Per-pair (vdW, es) energies of an explicit pair list with exact erfc
    electrostatics, each scaled by rescale_mask (P, 2) [q_scale, lj_scale]
    (the exact form of the JAX function of this name; the polynomial form
    is specific_pairs_energy_force). Differentiable in conf and params."""
    l, r = pairs[:, 0], pairs[:, 1]
    q, sig, eps, w = params.unbind(1)
    vdw, es = _exact_pair_energy(
        periodic_delta(conf[l], conf[r], box), w[l] - w[r], q[l] * q[r], combine_sigma(sig[l], sig[r]),
        combine_epsilon(eps[l], eps[r]), beta, cutoff,
    )
    vdw = torch.where(rescale_mask[:, 1] != 0, vdw * rescale_mask[:, 1], 0.0)
    es = torch.where(rescale_mask[:, 0] != 0, es * rescale_mask[:, 0], 0.0)
    return vdw, es


def water_exclusion_energy(conf, params, box, nw: int, beta, cutoff):
    """Energy of the first nw waters' three intra pairs with full scales and
    exact erfc electrostatics, on strided slices (the exact form of the JAX
    function of this name; the polynomial form is
    water_exclusion_energy_force). Differentiable in conf and params."""
    x = conf[: 3 * nw].reshape(nw, 3, 3)
    p = params[: 3 * nw].reshape(nw, 3, 4)
    u = conf.new_zeros(())
    for a, b in ((0, 1), (0, 2), (1, 2)):
        pa, pb = p[:, a], p[:, b]
        vdw, es = _exact_pair_energy(
            periodic_delta(x[:, a], x[:, b], box), pa[:, 3] - pb[:, 3], pa[:, 0] * pb[:, 0],
            combine_sigma(pa[:, 1], pb[:, 1]), combine_epsilon(pa[:, 2], pb[:, 2]), beta, cutoff,
        )
        u = u + torch.sum(vdw) + torch.sum(es)
    return u


def water_exclusion_energy_force(conf, params, box, nw: int, cutoff, h_coeffs):
    """(u, dU/dx) of the first nw waters' three intra pairs with full scales
    (the counterpart of water_exclusion_energy and its gradient). Water w is
    atoms 3w..3w+2, so the gradient is assembled by a reshape."""
    x = conf[: 3 * nw].reshape(nw, 3, 3)
    p = params[: 3 * nw].reshape(nw, 3, 4)
    u = conf.new_zeros(())
    g = {}
    for a, b in ((0, 1), (0, 2), (1, 2)):
        pa, pb = p[:, a], p[:, b]
        u_ab, g[a, b] = _poly_pair_grad(
            periodic_delta(x[:, a], x[:, b], box), pa[:, 3] - pb[:, 3], pa[:, 0] * pb[:, 0],
            combine_sigma(pa[:, 1], pb[:, 1]), combine_epsilon(pa[:, 2], pb[:, 2]), cutoff, h_coeffs,
        )
        u = u + torch.sum(u_ab)
    # out of place, so that it vmaps with params batched and conf not
    grad = torch.stack([g[0, 1] + g[0, 2], -g[0, 1] + g[1, 2], -g[0, 2] - g[1, 2]], dim=1)
    return u, torch.cat([grad.reshape(3 * nw, 3), conf.new_zeros((conf.shape[0] - 3 * nw, 3))])


def _exact_pair_terms(d, dw, qij, sig_ij, eps_ij, beta, cutoff):
    """(vdW, es, dvdW/dr, des/dr) per pair: the energies of
    _exact_pair_energy and their closed-form derivatives in the lifted
    distance r = sqrt(|d|^2 + dw^2), zero at or beyond the cutoff and for
    coincident points."""
    vdw, es = _exact_pair_energy(d, dw, qij, sig_ij, eps_ij, beta, cutoff)
    d2 = torch.sum(d * d, dim=-1) + dw * dw
    r = torch.sqrt(torch.where(d2 > 0, d2, 1.0))
    live = (d2 > 0) & (r < cutoff)
    inv_r = 1.0 / r
    sig6 = (sig_ij * inv_r) ** 6
    dvdw = torch.where(live & (eps_ij != 0), 4.0 * eps_ij * inv_r * (6.0 * sig6 - 12.0 * sig6 * sig6), 0.0)
    erfc_r = torch.special.erfc(beta * r)
    a = 0.5 * math.pi * (r / SWITCH_CUTOFF) ** 8  # the switch's argument; da/dr = 8 a / r
    inside = r < SWITCH_CUTOFF
    sw = torch.where(inside, torch.cos(a) ** 3, 0.0)
    dsw = torch.where(inside, -3.0 * torch.cos(a) ** 2 * torch.sin(a) * (8.0 * a * inv_r), 0.0)
    derfc = -2.0 * beta / math.sqrt(math.pi) * torch.exp(-((beta * r) ** 2))
    des = torch.where(live, qij * ((derfc - erfc_r * inv_r) * inv_r * sw + erfc_r * inv_r * dsw), 0.0)
    return vdw, es, dvdw, des


def _pair_grad(d, dw, de_dr):
    """dU/d(x_l) of pairs (l, r) from dU/dr in the lifted distance."""
    d2 = torch.sum(d * d, dim=-1) + dw * dw
    inv_r = torch.where(d2 > 0, torch.rsqrt(torch.where(d2 > 0, d2, 1.0)), 0.0)
    return (de_dr * inv_r)[..., None] * d


def water_exclusion_exact_energy_force(conf, params, box, nw: int, beta, cutoff):
    """(u, dU/dx) of water_exclusion_energy in closed form (exact erfc),
    assembled by a reshape as water_exclusion_energy_force."""
    x = conf[: 3 * nw].reshape(nw, 3, 3)
    p = params[: 3 * nw].reshape(nw, 3, 4)
    u = conf.new_zeros(())
    g = {}
    for a, b in ((0, 1), (0, 2), (1, 2)):
        pa, pb = p[:, a], p[:, b]
        d, dw = periodic_delta(x[:, a], x[:, b], box), pa[:, 3] - pb[:, 3]
        vdw, es, dvdw, des = _exact_pair_terms(
            d, dw, pa[:, 0] * pb[:, 0], combine_sigma(pa[:, 1], pb[:, 1]), combine_epsilon(pa[:, 2], pb[:, 2]),
            beta, cutoff,
        )
        u = u + torch.sum(vdw) + torch.sum(es)
        g[a, b] = _pair_grad(d, dw, dvdw + des)
    grad = torch.stack([g[0, 1] + g[0, 2], -g[0, 1] + g[1, 2], -g[0, 2] - g[1, 2]], dim=1)
    return u, torch.cat([grad.reshape(3 * nw, 3), conf.new_zeros((conf.shape[0] - 3 * nw, 3))])


def specific_pairs_exact_energy_force(conf, params, box, pairs, beta, cutoff, rescale_mask, assemble):
    """(u, force) of nonbonded_on_specific_pairs summed: u the sum of the
    scaled pair energies, force = -dU/dx in closed form, summed onto atoms
    by `assemble`, a SegmentSum over cat([pairs[:, 0], pairs[:, 1]])."""
    l, r = pairs[:, 0], pairs[:, 1]
    q, sig, eps, w = params.unbind(1)
    d = periodic_delta(conf[l], conf[r], box)
    dw = w[l] - w[r]
    vdw, es, dvdw, des = _exact_pair_terms(
        d, dw, q[l] * q[r], combine_sigma(sig[l], sig[r]), combine_epsilon(eps[l], eps[r]), beta, cutoff
    )
    s_q, s_lj = rescale_mask[:, 0], rescale_mask[:, 1]
    vdw, dvdw = (torch.where(s_lj != 0, t * s_lj, 0.0) for t in (vdw, dvdw))
    es, des = (torch.where(s_q != 0, t * s_q, 0.0) for t in (es, des))
    g = _pair_grad(d, dw, dvdw + des)
    return torch.sum(vdw) + torch.sum(es), assemble(torch.cat([-g, g]))


def nonbonded_on_precomputed_pairs(conf, params, box, pairs, beta, cutoff):
    """Per-pair (vdW, es) of a pair list whose parameter rows are already
    combined, [q_ij, sigma_ij, eps_ij, dw_ij] (the single-topology ligand's
    intramolecular term), exact erfc electrostatics. Differentiable."""
    l, r = pairs[:, 0], pairs[:, 1]
    q_ij, sig_ij, eps_ij, dw = params.unbind(1)
    return _exact_pair_energy(periodic_delta(conf[l], conf[r], box), dw, q_ij, sig_ij, eps_ij, beta, cutoff)


def precomputed_pairs_energy_force(conf, params, box, pairs, beta, cutoff, assemble):
    """(u, force) of nonbonded_on_precomputed_pairs summed, force in closed
    form, summed onto atoms by `assemble` as in specific_pairs_exact_energy_force."""
    l, r = pairs[:, 0], pairs[:, 1]
    q_ij, sig_ij, eps_ij, dw = params.unbind(1)
    d = periodic_delta(conf[l], conf[r], box)
    vdw, es, dvdw, des = _exact_pair_terms(d, dw, q_ij, sig_ij, eps_ij, beta, cutoff)
    g = _pair_grad(d, dw, dvdw + des)
    return torch.sum(vdw) + torch.sum(es), assemble(torch.cat([-g, g]))


def _group_grid(conf, params, box, a_idxs, b_idxs, beta, cutoff):
    """The (R, C) grid of rows a_idxs x columns b_idxs: displacements and
    _exact_pair_terms."""
    q, sig, eps, w = params.unbind(1)
    d = periodic_delta(conf[a_idxs][:, None, :], conf[b_idxs][None, :, :], box)
    dw = w[a_idxs][:, None] - w[b_idxs][None, :]
    terms = _exact_pair_terms(
        d, dw, q[a_idxs][:, None] * q[b_idxs][None, :], combine_sigma(sig[a_idxs][:, None], sig[b_idxs][None, :]),
        combine_epsilon(eps[a_idxs][:, None], eps[b_idxs][None, :]), beta, cutoff,
    )
    return d, dw, terms


def nonbonded_interaction_groups(conf, params, box, a_idxs, b_idxs, beta, cutoff):
    """Per-pair (vdW, es), each (R * C,), of every row atom a_idxs[i] with
    every column atom b_idxs[j] (disjoint sets), exact erfc electrostatics.
    Differentiable."""
    _, _, (vdw, es, _, _) = _group_grid(conf, params, box, a_idxs, b_idxs, beta, cutoff)
    return vdw.reshape(-1), es.reshape(-1)


def interaction_group_energy_force(conf, params, box, a_idxs, b_idxs, beta, cutoff, col_mask=None):
    """(u, force) of the interaction group in grid form: each side's force
    is a sum over the other axis of the (R, C) grid, and the two sides are
    written by assignment at their own (disjoint, unique) atoms, so the
    result is the same bits on any device.

    col_mask (C,) bool, where given: a False column contributes nothing,
    so that a caller that splits the columns over ranks can pad its share
    with a repeated real index (parallel/spatial_md.py); the columns' forces
    are then added at their atoms (index_add_), repeats included."""
    d, dw, (vdw, es, dvdw, des) = _group_grid(conf, params, box, a_idxs, b_idxs, beta, cutoff)
    if col_mask is not None:
        keep = torch.as_tensor(col_mask, device=conf.device)[None, :]
        vdw, es, dvdw, des = (torch.where(keep, t, 0.0) for t in (vdw, es, dvdw, des))
    g = _pair_grad(d, dw, dvdw + des)  # dU/d(x_a) per pair
    force = torch.zeros_like(conf)
    force[a_idxs] = -torch.sum(g, dim=1)
    if col_mask is None:
        force[b_idxs] = torch.sum(g, dim=0)
    else:
        force.index_add_(0, torch.as_tensor(b_idxs, device=conf.device), torch.sum(g, dim=0))
    return torch.sum(vdw) + torch.sum(es), force


def nonbonded_block_unsummed(xi, xj, box, params_i, params_j, beta, cutoff):
    """(..., R, M) energies of every atom of xi (..., R, 3) with every atom
    of xj (..., M, 3), no exclusions, over any leading batch dimensions
    shared by the coordinates, parameters and box (..., 3, 3) (None:
    vacuum): the 4D distance, switched-erfc electrostatics plus LJ, 0 at
    and beyond the cutoff. Coincident points give NaN, as JAX's function
    does; its callers mask them."""
    diff = xi[..., :, None, :] - xj[..., None, :, :]
    if box is not None:
        box_diag = torch.diagonal(box, dim1=-2, dim2=-1)[..., None, None, :]
        diff = diff - box_diag * torch.floor(diff / box_diag + 0.5)
    dw = params_i[..., :, None, 3] - params_j[..., None, :, 3]
    dij = torch.sqrt(torch.sum(diff * diff, dim=-1) + dw * dw)
    sig_ij = combine_sigma(params_i[..., :, None, 1], params_j[..., None, :, 1])
    eps_ij = combine_epsilon(params_i[..., :, None, 2], params_j[..., None, :, 2])
    qij = params_i[..., :, None, 0] * params_j[..., None, :, 0]
    es = switched_direct_space_pme(dij, qij, beta)
    lj = lennard_jones(dij, sig_ij, eps_ij)
    return torch.where(dij < cutoff, es + lj, 0.0)


def nonbonded_block(xi, xj, box, params_i, params_j, beta, cutoff):
    """The sum of nonbonded_block_unsummed over its last two axes."""
    return torch.sum(nonbonded_block_unsummed(xi, xj, box, params_i, params_j, beta, cutoff), dim=(-2, -1))


# (rows x columns) slots of one dense row block: 2^16 keeps a block's float64
# temporaries cache-sized on the CPU, also under a vmap over a dozen replicas
DENSE_BLOCK_ELEMENTS = {"cpu": 1 << 16, "cuda": 1 << 22}


def dense_row_blocks(n: int, elements: int) -> list:
    """[(r0, r1)] Newton-triangular row blocks of n atoms: rows [r0, r1)
    against columns [r0, n), at most `elements` slots a block (one row at
    least)."""
    blocks, r0 = [], 0
    while r0 < n:
        r1 = min(n, r0 + max(1, elements // (n - r0)))
        blocks.append((r0, r1))
        r0 = r1
    return blocks


def dense_block(x, p, box, r0: int, r1: int, beta, cutoff, q_mask=None, lj_mask=None, forces: bool = False):
    """One row block of the dense form over atoms x (n, 3), params p (n, 4):
    rows [r0, r1) against columns [r0, n), each pair once (column after
    row) where 0 < r^2 < cutoff^2, its LJ and exact-erfc terms scaled by
    q_mask / lj_mask (r1 - r0, n - r0) where given. Returns u, or (u, dU/dx
    of the rows (r1 - r0, 3), dU/dx of the columns (n - r0, 3)) in closed
    form. Every slot outside the gate takes r^2 := 1, so each term is
    finite and differentiable."""
    xi, pi, xj, pj = x[r0:r1], p[r0:r1], x[r0:], p[r0:]
    d = [periodic_delta(xi[:, None, a], xj[None, :, a], None if box is None else box[a : a + 1, a : a + 1]) for a in range(3)]
    dw = pi[:, None, 3] - pj[None, :, 3]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + dw * dw
    upper = torch.arange(r1 - r0, device=x.device)[:, None] < torch.arange(x.shape[0] - r0, device=x.device)[None, :]
    live = upper & (d2 < cutoff * cutoff) & (d2 > 0)
    c_q = live.to(p.dtype) if q_mask is None else torch.where(live, q_mask, 0.0)
    c_lj = live.to(p.dtype) if lj_mask is None else torch.where(live, lj_mask, 0.0)
    r2 = torch.where(live, d2, 1.0)
    inv_r = torch.rsqrt(r2)
    r, inv_r2 = r2 * inv_r, inv_r * inv_r
    sig = combine_sigma(pi[:, None, 1], pj[None, :, 1])
    s2 = sig * sig * inv_r2
    t6 = s2 * s2 * s2
    eps_ij = combine_epsilon(pi[:, None, 2], pj[None, :, 2])
    eps4 = 4.0 * torch.where(eps_ij != 0, eps_ij * c_lj, 0.0)  # as JAX's select: no dU/d eps_i on eps_ij = 0 pairs
    qij = pi[:, None, 0] * pj[None, :, 0] * c_q
    erfc_r = torch.special.erfc(beta * r)
    a = (0.5 * math.pi / SWITCH_CUTOFF**8) * (r2 * r2) * (r2 * r2)  # the switch's argument
    cos_a = torch.cos(a)
    sw = torch.where(r < SWITCH_CUTOFF, cos_a * cos_a * cos_a, 0.0)
    s_r = erfc_r * inv_r
    u = torch.sum(eps4 * (t6 * t6 - t6)) + torch.sum(qij * s_r * sw)
    if not forces:
        return u
    dsw = torch.where(r < SWITCH_CUTOFF, -24.0 * a * cos_a * cos_a * torch.sin(a) * inv_r, 0.0)
    ds_r = (-2.0 * beta / math.sqrt(math.pi)) * torch.exp(-((beta * r) ** 2)) * inv_r - s_r * inv_r
    g = (eps4 * inv_r2 * (6.0 * t6 - 12.0 * t6 * t6) + qij * (ds_r * sw + s_r * dsw) * inv_r)  # dE/dr / r
    rows = torch.stack([torch.sum(g * da, 1) for da in d], 1)
    cols = torch.stack([-torch.sum(g * da, 0) for da in d], 1)
    return u, rows, cols


def _dense_sum(x, p, box, blocks, beta, cutoff, masks_of, forces: bool):
    """The blocks summed: u, or (u, dU/dx (n, 3)), out of place (vmaps)."""
    n = x.shape[0]
    u = x.new_zeros(())
    rows, cols = [], x.new_zeros((n, 3))
    # autograd would keep every block's temporaries: recompute them in the backward pass instead
    recompute = not forces and torch.is_grad_enabled() and (x.requires_grad or p.requires_grad)
    for k, (r0, r1) in enumerate(blocks):
        q_mask, lj_mask = masks_of(k, r0, r1)
        if forces:
            u_b, g_rows, g_cols = dense_block(x, p, box, r0, r1, beta, cutoff, q_mask, lj_mask, True)
            rows.append(g_rows)
            cols = cols + torch.nn.functional.pad(g_cols, (0, 0, r0, 0))
        elif not recompute:
            u_b = dense_block(x, p, box, r0, r1, beta, cutoff, q_mask, lj_mask)
        else:
            u_b = torch.utils.checkpoint.checkpoint(
                dense_block, x, p, box, r0, r1, beta, cutoff, q_mask, lj_mask, use_reentrant=False
            )
        u = u + u_b
    return (u, torch.cat(rows) + cols) if forces else u


def nonbonded_all_pairs_dense(conf, params, box, charge_rescale_mask, lj_rescale_mask, beta, cutoff, atom_mask=None):
    """Dense all-pairs energy with exclusion masks, JAX's function of this
    name: each pair within the cutoff scaled by the (N, N) masks (None: all
    ones; 1 - scale on excluded pairs, as JAX's exclusions_to_rescale_masks),
    only pairs of atoms where atom_mask (N,) is nonzero. Differentiable in
    conf and params; evaluated over Newton-triangular row blocks."""
    act = None if atom_mask is None else torch.nonzero(torch.as_tensor(atom_mask) > 0).squeeze(1).to(conf.device)
    x, p = (conf, params) if act is None else (conf[act], params[act])
    qm, ljm = charge_rescale_mask, lj_rescale_mask
    if act is not None:
        qm, ljm = (None if m is None else m[act][:, act] for m in (qm, ljm))
    blocks = dense_row_blocks(x.shape[0], DENSE_BLOCK_ELEMENTS["cpu"])

    def masks_of(k, r0, r1):
        return tuple(None if m is None else torch.as_tensor(m[r0:r1, r0:], device=p.device, dtype=p.dtype) for m in (qm, ljm))

    return _dense_sum(x, p, box, blocks, beta, cutoff, masks_of, forces=False)


class DenseAllPairs:
    """The dense form of the all-pairs term (JAX's impl="dense"): every pair
    of the atom subset `atom_idxs` (None: all atoms) within the cutoff, LJ
    plus exact-erfc electrostatics, excluded pairs scaled by 1 - scale
    (charge, LJ) as JAX's _dense_masks. Rows are taken in Newton-triangular
    blocks of at most DENSE_BLOCK_ELEMENTS slots (by device), so memory is
    O(N x block) and not O(N^2); the exclusions are kept as each block's
    flat slots and values.

      energy(conf, params, box) -> u      differentiable in conf and params
      energy_force(conf, params, box) -> (u, force)   closed form

    Both vmap over a leading axis of conf, params and box (no shape depends
    on the data)."""

    def __init__(self, num_atoms: int, beta: float, cutoff: float, exclusion_idxs=None, scale_factors=None,
                 atom_idxs=None, device=None):
        device = torch.device("cpu") if device is None else torch.device(device)
        self.num_atoms, self.beta, self.cutoff = num_atoms, float(beta), float(cutoff)
        act = np.arange(num_atoms) if atom_idxs is None else np.unique(np.asarray(atom_idxs, dtype=np.int64))
        self.act = None if atom_idxs is None else torch.as_tensor(act, device=device)
        n = act.shape[0]
        self.blocks = dense_row_blocks(n, DENSE_BLOCK_ELEMENTS.get(device.type, 1 << 22))
        pos = np.full(num_atoms, -1, dtype=np.int64)
        pos[act] = np.arange(n)
        exc = np.asarray(exclusion_idxs if exclusion_idxs is not None else np.zeros((0, 2)), dtype=np.int64).reshape(-1, 2)
        scales = np.asarray(scale_factors if scale_factors is not None else np.zeros((0, 2)), np.float64).reshape(-1, 2)
        a, c = pos[exc[:, 0]], pos[exc[:, 1]]
        inside = (a >= 0) & (c >= 0) & (a != c)
        a, c, scales = np.minimum(a, c)[inside], np.maximum(a, c)[inside], scales[inside]
        self._block_masks = []
        for r0, r1 in self.blocks:
            sel = (a >= r0) & (a < r1)
            flat = (a[sel] - r0) * (n - r0) + (c[sel] - r0)
            self._block_masks.append(
                None if not sel.any() else (
                    torch.as_tensor(flat, device=device), torch.as_tensor(1.0 - scales[sel], device=device)
                )
            )

    def _masks_of(self, dtype):
        n = self.num_atoms if self.act is None else len(self.act)

        def masks_of(k, r0, r1):
            entry = self._block_masks[k]
            if entry is None:
                return None, None
            flat, vals = entry
            shape = (r1 - r0, n - r0)
            ones = torch.ones(shape[0] * shape[1], dtype=dtype, device=flat.device)
            return tuple(ones.index_put((flat,), vals[:, col].to(dtype)).view(shape) for col in (0, 1))

        return masks_of

    def _subset(self, conf, params):
        if self.act is None:
            return conf, params
        return conf[..., self.act, :], params[..., self.act, :]

    def energy(self, conf, params, box):
        x, p = self._subset(conf, params)
        return _dense_sum(x, p, box, self.blocks, self.beta, self.cutoff, self._masks_of(p.dtype), forces=False)

    def energy_force(self, conf, params, box):
        x, p = self._subset(conf, params)
        u, grad = _dense_sum(x, p, box, self.blocks, self.beta, self.cutoff, self._masks_of(p.dtype), forces=True)
        if self.act is not None:
            grad = conf.new_zeros(conf.shape).index_copy(0, self.act, grad)
        return u, -grad


# The ligand-environment interaction group as dot products in the ligand's
# parameters (the linear-basis expansion), so that frames can be rescored for
# new ligand charges or LJ parameters without revisiting the environment. The
# ligand's coordinates may carry leading frame axes, (..., N_lig, 3) against
# (..., N_env, 3) and a box (..., 3, 3): every (ligand, environment) distance
# of a frame is taken at once.


def _ligand_env_distances(x_ligand, x_env, box, cutoff):
    """(..., N_lig, N_env) minimum-image distances, +inf beyond cutoff."""
    diff = x_ligand[..., :, None, :] - x_env[..., None, :, :]
    if box is not None:
        box_diag = torch.diagonal(box, dim1=-2, dim2=-1)[..., None, None, :]
        diff = diff - box_diag * torch.floor(diff / box_diag + 0.5)
    d2 = torch.sum(diff * diff, dim=-1)
    return torch.where(d2 <= cutoff**2, torch.sqrt(d2), torch.inf)


def coulomb_prefactors_on_snapshot(x_ligand, x_env, q_env, box=None, beta=2.0, cutoff=float("inf")):
    """(..., N_lig): prefactor_i = sum_j q_j erfc(beta d_ij) switch(d_ij) / d_ij."""
    d = _ligand_env_distances(x_ligand, x_env, box, cutoff)
    return torch.sum(q_env[..., None, :] / d * torch.special.erfc(beta * d) * switch_fn(d), dim=-1)


def coulomb_interaction_group_energy(q_ligand, q_prefactors):
    return q_prefactors @ q_ligand


def _lj_basis_powers(power):
    from scipy.special import binom

    exponents = power - np.arange(power + 1)
    return exponents, binom(power, exponents)


def basis_expand_lj_env(sig_env, eps_env, r_env):
    """(..., 20) basis vector summarizing the environment for the linear-basis
    LJ expansion; r_env (..., N_env) and sig_env, eps_env (..., N_env) give
    one vector per leading index."""
    parts = []
    for power, sign in ((12, 1.0), (6, -1.0)):
        exps, coeffs = _lj_basis_powers(power)
        exps = torch.as_tensor(exps, dtype=sig_env.dtype, device=sig_env.device)
        coeffs = torch.as_tensor(coeffs, dtype=sig_env.dtype, device=sig_env.device)
        raised = sig_env[..., None, :] ** exps[:, None] * coeffs[:, None] * eps_env[..., None, :]
        h = 4.0 * torch.einsum("...j,...kj->...k", r_env ** (-power), raised)
        parts.append(sign * h)
    return torch.cat(parts, dim=-1)


def basis_expand_lj_atom(sig, eps):
    """(..., 20) projection of each atom's (sigma, eps) onto the basis."""
    sig = torch.as_tensor(sig)
    exponents = torch.cat([torch.arange(13.0), torch.arange(7.0)]).to(sig.dtype).to(sig.device)
    return torch.as_tensor(eps)[..., None] * sig[..., None] ** exponents


def lj_prefactors_on_snapshot(x_ligand, x_env, sig_env, eps_env, box=None, cutoff=float("inf")):
    """(..., N_lig, 20) environment prefactors."""
    r = _ligand_env_distances(x_ligand, x_env, box, cutoff)
    return basis_expand_lj_env(sig_env[..., None, :], eps_env[..., None, :], r)


def lj_interaction_group_energy(sig_ligand, eps_ligand, lj_prefactors):
    """sum over the ligand's atoms and the basis; leading frame axes of
    lj_prefactors stay."""
    projection = basis_expand_lj_atom(sig_ligand, eps_ligand)
    return torch.sum(projection * lj_prefactors, dim=(-2, -1))
