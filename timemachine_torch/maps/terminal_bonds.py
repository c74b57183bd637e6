"""Invertible terminal-bond-length maps for targeted FEP (the port of
timemachine_tpu/maps/terminal_bonds.py).

When two states differ only in terminal HarmonicBond parameters, samples
move between them by rescaling each terminal bond's length from the source
state's thermal window onto the destination's. The terminal atom moves
radially about its fixed anchor, so log|det J| is analytic, log f'(r) + 2
log(f(r) / r) in 3D, as in JAX's (the CPU tests hold it to torch.func's
Jacobian). Terminal atoms are distinct and anchors never move, so all bond
maps apply in one vectorized pass over a trajectory, on the map's device
(None: the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ, DEFAULT_TEMP
from timemachine_torch.device import resolve_device, working_dtype

# the support window's half-width, in thermal standard deviations
DEFAULT_SIGMA_THRESH = 20


def thermal_length_window(force_constant, eq_length, temperature, sigma_thresh=DEFAULT_SIGMA_THRESH):
    """(lower, upper) support window of a harmonic bond's length at T:
    r0 +- thresh sqrt(kT / k), vectorized over bonds."""
    sig = np.sqrt(BOLTZ * temperature / np.asarray(force_constant))
    lo = np.asarray(eq_length) - sigma_thresh * sig
    hi = np.asarray(eq_length) + sigma_thresh * sig
    if np.any(lo <= 0):
        raise ValueError("thermal window extends to non-positive bond lengths; reduce sigma_thresh")
    return lo, hi


def find_terminal_bonds(bond_idxs) -> np.ndarray:
    """(anchor, terminal) pairs of every bond with a degree-1 atom, sorted;
    the degrees by bincount over the bond list."""
    bond_idxs = np.asarray(bond_idxs, dtype=int)
    degree = np.bincount(bond_idxs.reshape(-1))
    out = []
    for i, j in bond_idxs:
        # orient (higher-degree anchor, degree-1 terminal); ties keep (i, j)
        anchor, term = (i, j) if degree[i] >= degree[j] else (j, i)
        if degree[term] == 1:
            out.append((int(anchor), int(term)))
    return np.array(sorted(out)).reshape(-1, 2)


def _rescale_lengths(r, src_lo, src_hi, dst_lo, dst_hi):
    """The affine window-to-window length map and the radial map's
    log|det J| per bond; NaN outside the source window."""
    slope = (dst_hi - dst_lo) / (src_hi - src_lo)
    r_new = dst_lo + (r - src_lo) * slope
    inside = (r >= src_lo) & (r <= src_hi)
    r_new = torch.where(inside, r_new, torch.nan)
    logdetjac = torch.log(slope) + 2.0 * (torch.log(r_new) - torch.log(r))
    return r_new, logdetjac


@dataclass(frozen=True)
class TerminalMappableState:
    """Terminal-bond geometry of one state: (anchor, terminal) index pairs
    and their thermal length windows."""

    idxs: np.ndarray  # (B, 2) int
    window_lo: np.ndarray  # (B,)
    window_hi: np.ndarray  # (B,)

    @classmethod
    def from_harmonic_bond_params(
        cls, bond_idxs, params, temperature=DEFAULT_TEMP, sigma_thresh=DEFAULT_SIGMA_THRESH
    ) -> "TerminalMappableState":
        params = params.detach().cpu().numpy() if isinstance(params, torch.Tensor) else np.asarray(params)
        by_bond = {frozenset(map(int, b)): p for b, p in zip(np.asarray(bond_idxs), params)}
        terminal = find_terminal_bonds(bond_idxs)
        ks = np.array([by_bond[frozenset(b)][0] for b in terminal])
        r0s = np.array([by_bond[frozenset(b)][1] for b in terminal])
        lo, hi = thermal_length_window(ks, r0s, temperature, sigma_thresh)
        return cls(terminal, lo, hi)

    def window_of(self, bond) -> tuple[float, float]:
        for (a, t), lo, hi in zip(self.idxs, self.window_lo, self.window_hi):
            if (a, t) == tuple(bond):
                return float(lo), float(hi)
        raise KeyError(bond)

    def contains_in_support(self, x) -> bool:
        x = np.asarray(x)
        r = np.linalg.norm(x[self.idxs[:, 1]] - x[self.idxs[:, 0]], axis=-1)
        return bool(np.all((r >= self.window_lo) & (r <= self.window_hi)))


@dataclass(frozen=True)
class TerminalBondMap:
    """Invertible map carrying conformers between two states' terminal bond
    windows; on a trajectory xs (T, N, 3), a tensor or numpy, it returns
    (xs', log|det J| (T,)) as tensors on `device` (None: the card) in its
    working dtype."""

    idxs: np.ndarray  # (B, 2) (anchor, terminal) of the bonds whose windows differ
    src_lo: np.ndarray
    src_hi: np.ndarray
    dst_lo: np.ndarray
    dst_hi: np.ndarray
    device: object = None

    @classmethod
    def from_states(cls, src: TerminalMappableState, dst: TerminalMappableState, device=None) -> "TerminalBondMap":
        shared = sorted(set(map(tuple, src.idxs.tolist())) & set(map(tuple, dst.idxs.tolist())))
        rows = []
        for bond in shared:
            s_lo, s_hi = src.window_of(bond)
            d_lo, d_hi = dst.window_of(bond)
            if (s_lo, s_hi) != (d_lo, d_hi):
                rows.append((bond, s_lo, s_hi, d_lo, d_hi))
        bonds, s_lo, s_hi, d_lo, d_hi = zip(*rows) if rows else ((), (), (), (), ())
        return cls(np.array(bonds, dtype=int).reshape(-1, 2), np.array(s_lo), np.array(s_hi), np.array(d_lo),
                   np.array(d_hi), device)

    def __call__(self, xs):
        device = resolve_device(self.device)
        xs = torch.as_tensor(xs, device=device, dtype=working_dtype(device))
        if len(self.idxs) == 0:
            return xs, torch.zeros(xs.shape[0], dtype=xs.dtype, device=xs.device)

        def t(a):
            return torch.as_tensor(a, device=xs.device, dtype=xs.dtype)

        anchors = torch.as_tensor(self.idxs[:, 0], device=xs.device)
        terminals = torch.as_tensor(self.idxs[:, 1], device=xs.device)
        vec = xs[:, terminals] - xs[:, anchors]  # (T, B, 3)
        r = torch.linalg.norm(vec, dim=-1)
        r_new, ldj = _rescale_lengths(r, t(self.src_lo), t(self.src_hi), t(self.dst_lo), t(self.dst_hi))
        out = xs.clone()
        out[:, terminals] = xs[:, anchors] + vec * (r_new / r)[..., None]
        return out, torch.sum(ldj, dim=-1)
