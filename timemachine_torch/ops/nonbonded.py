"""Nonbonded math: Lennard-Jones plus switched-erfc Coulomb in 4D
(counterpart of timemachine_tpu/ops/nonbonded.py).

Per-atom parameter rows are [q sqrt(138.935456), sigma/2, sqrt(eps), w]:
sigma_ij = s_i + s_j, eps_ij = e_i e_j, and the pair distance is
sqrt(|dr|^2 + (w_i - w_j)^2). The all-pairs term runs in the rowscan sweep
(ops/rowscan_kernel.py); this module holds the dense oracle and the
exclusion corrections, which evaluate the sweep's own polynomial
electrostatics so that they cancel it exactly.
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


def switched_direct_space_pme(dij, qij, beta):
    return qij * torch.special.erfc(beta * dij) / dij * switch_fn(dij)


def nonbonded_all_pairs_dense(conf, params, box, beta, cutoff):
    """Dense O(N^2) all-pairs energy, exact erfc, no exclusions. The oracle
    for small systems only: it holds (N, N) intermediates."""
    n = conf.shape[0]
    q, sig, eps, w = params.unbind(1)
    dr = periodic_delta(conf[:, None, :], conf[None, :, :], box)
    dw = w[:, None] - w[None, :]
    d2 = torch.sum(dr * dr, dim=-1) + dw * dw
    eye = torch.eye(n, dtype=torch.bool, device=conf.device)
    dij = torch.sqrt(torch.where(eye, 1.0, d2))
    keep = ~eye & (dij < cutoff)
    eps_ij = torch.where(keep, combine_epsilon(eps[:, None], eps[None, :]), 0.0)
    lj = torch.where(eps_ij != 0, lennard_jones(dij, combine_sigma(sig[:, None], sig[None, :]), eps_ij), 0.0)
    es = torch.where(keep, switched_direct_space_pme(dij, q[:, None] * q[None, :], beta), 0.0)
    return 0.5 * torch.sum(lj + es)


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


def specific_pairs_energy_force(conf, params, box, pairs, cutoff, rescale_mask, h_coeffs, assemble):
    """(u, force) of an explicit pair list with polynomial electrostatics:
    u = sum of scaled pair energies, force = -dU/dx. rescale_mask (P, 2)
    holds [q_scale, lj_scale]; `assemble` is a SegmentSum over
    cat([pairs[:, 0], pairs[:, 1]]) onto atoms."""
    l, r = pairs[:, 0], pairs[:, 1]
    q, sig, eps, w = params.unbind(1)
    d = periodic_delta(conf[l], conf[r], box)
    u, g = _poly_pair_grad(
        d, w[l] - w[r], q[l] * q[r] * rescale_mask[:, 0], combine_sigma(sig[l], sig[r]),
        combine_epsilon(eps[l], eps[r]) * rescale_mask[:, 1], cutoff, h_coeffs,
    )
    return torch.sum(u), assemble(torch.cat([-g, g]))


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


def water_exclusion_energy_force(conf, params, box, nw: int, cutoff, h_coeffs):
    """(u, dU/dx) of the first nw waters' three intra pairs with full scales
    (the counterpart of water_exclusion_energy and its gradient). Water w is
    atoms 3w..3w+2, so the gradient is assembled by a reshape."""
    x = conf[: 3 * nw].reshape(nw, 3, 3)
    p = params[: 3 * nw].reshape(nw, 3, 4)
    u = conf.new_zeros(())
    grad = torch.zeros_like(x)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        pa, pb = p[:, a], p[:, b]
        u_ab, g = _poly_pair_grad(
            periodic_delta(x[:, a], x[:, b], box), pa[:, 3] - pb[:, 3], pa[:, 0] * pb[:, 0],
            combine_sigma(pa[:, 1], pb[:, 1]), combine_epsilon(pa[:, 2], pb[:, 2]), cutoff, h_coeffs,
        )
        u = u + torch.sum(u_ab)
        grad[:, a] += g
        grad[:, b] -= g
    return u, torch.cat([grad.reshape(3 * nw, 3), conf.new_zeros((conf.shape[0] - 3 * nw, 3))])
