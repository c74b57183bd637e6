"""Potentials of the host system as `nn.Module`s
(counterpart of timemachine_tpu/potentials.py).

Each module holds its index and parameter buffers (a JAX BoundPotential's
potential + params) and offers

  energy(x, box) -> u
  energy_force(x, box) -> (u, force),  force = -dU/dx, closed form
  u(x, params, box) -> u,  differentiable in x and params (du/dp)

Bonded terms sum their per-term forces with a fixed-order SegmentSum, so a
step is bitwise reproducible on the card. `Nonbonded` also offers the
stateful MD provider the Context uses (`md_force_provider`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from timemachine_torch.device import resolve_device
from timemachine_torch.ops import bonded, nonbonded
from timemachine_torch.ops import dotscan_kernel as dk
from timemachine_torch.ops import gather_kernel as gk
from timemachine_torch.ops import nonbonded_kernel as nbk
from timemachine_torch.ops import quadscan_kernel as qk
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.ops.segment import SegmentSum

# list capacity over the count at configure time, the MD lists' skin (nm)
# and their rebuild period (steps), as the JAX package's rowscan path
MARGIN, SKIN, REBUILD_INTERVAL = 1.4, 0.1, 20
DP_CB = 2  # column super-block width of the block-tile lists, as the JAX package's configure_pallas


class _BondedTerm(nn.Module):
    """Shared shape of the valence terms: idxs (T, k) atoms, params (T, 3|2)."""

    # bond-graph-local: a rigid per-molecule move (the barostat's) leaves the
    # energy unchanged, so volume moves skip the term
    rigid_group_invariant = True

    def __init__(self, idxs, params, num_atoms: int, device=None, dtype=torch.float64):
        super().__init__()
        device = resolve_device(device)
        idxs = np.ascontiguousarray(idxs, dtype=np.int64)
        if idxs.size and (idxs.min() < 0 or idxs.max() >= num_atoms):
            raise ValueError(f"{type(self).__name__}: atom index out of range")
        self.register_buffer("idxs", torch.tensor(idxs, device=device))
        self.register_buffer("params", torch.tensor(np.ascontiguousarray(params), device=device, dtype=dtype))
        # role-major: contributions arrive as cat([role 0 rows, role 1 rows, ...])
        self.assemble = SegmentSum(idxs.T.ravel(), num_atoms, device=device)

    def u(self, x, params, box):
        """Energy as a function of (x, params, box), differentiable in both
        by autograd (the counterpart of the JAX potential's __call__)."""
        return type(self)._energy(x, params, box, self.idxs)

    def energy(self, x, box):
        return self.u(x, self.params, box)

    def energy_force(self, x, box):
        u, contribs = type(self)._contribs(x, self.params, self.idxs)
        return u, self.assemble(torch.cat(contribs))


class HarmonicBond(_BondedTerm):
    _energy = staticmethod(bonded.harmonic_bond)
    _contribs = staticmethod(bonded.bond_force_contribs)


class HarmonicAngle(_BondedTerm):
    _energy = staticmethod(bonded.harmonic_angle)
    _contribs = staticmethod(bonded.angle_force_contribs)


class PeriodicTorsion(_BondedTerm):
    _energy = staticmethod(bonded.periodic_torsion)
    _contribs = staticmethod(bonded.torsion_force_contribs)


class NonbondedAllPairs(nn.Module):
    """All-pairs LJ + switched Coulomb in 4D, no exclusions. Call
    `configure(box, conf, kernel)` once before use: it picks the kernel and
    sizes the list capacities from the geometry.

    kernel="rowscan" (the MD main path): the rowscan sweep with polynomial
    electrostatics over Newton-triangular lists, as JAX's configure_pallas;
    its MD provider images every atom to its row chunk's center
    (`md_preshift`) where dotscan_valid holds at cutoff + SKIN, and leaves w
    out of r^2 unless `rowscan_has_w` (a nonzero w then gives NaN).
    kernel="gather": the same pair function over atom-exact
    full neighbour lists, for energy, force and MD. kernel="quad": rowscan
    for energy and force, the Newton-triangular quadscan sweep for MD, with
    w in r^2 unless `quad_has_w` is False (a nonzero w then gives NaN); it
    falls back to rowscan wholesale where the constant-shift invariant
    fails at cutoff + SKIN (small boxes). kernel="dot": rowscan for energy
    and force, the dotscan sweep (row-center images, forces by contraction) over Newton-triangular lists for MD, on the snake
    sort, else the Hilbert sort, whichever passes the image bound at cutoff
    + SKIN first (`dot_sort`); where neither does, rowscan wholesale.
    kernel="v1": the block-tile sweep with exact electrostatics, lists at
    cutoff + SKIN for MD. `kernel` then names the configuration taken. Either way `u(x, params, box)` is
    differentiable in params through the block-tile kernel's DP pass (exact
    electrostatics, as in the JAX package)."""

    rigid_group_invariant = False

    def __init__(self, num_atoms: int, beta: float, cutoff: float, params, device=None, dtype=torch.float64):
        super().__init__()
        device = resolve_device(device)
        self.num_atoms = num_atoms
        self.beta = float(beta)
        self.cutoff = float(cutoff)
        self.register_buffer("params", torch.tensor(np.ascontiguousarray(params), device=device, dtype=dtype))
        # the exclusion corrections' electrostatics: the rowscan polynomial, or None for exact erfc
        self.h_coeffs = rs.es_energy_force_series(self.beta, self.cutoff)[0]
        self._energy = self._energy_force = self._u = self._md = None
        self.kernel = None

    def configure(self, box, conf, kernel: str = "rowscan", rowscan_has_w: bool = True, quad_has_w: bool = True):
        """Size the lists from this geometry, at MARGIN over the present
        counts: the energy/force lists at the bare cutoff, the MD lists at
        cutoff + SKIN (with a sort-cell size from a census of swept slots
        for rowscan systems of 8,192 atoms and up), the du/dp lists at the
        bare cutoff with column super-blocks DP_CB wide (the block-tile
        lists, du/dp and v1, are Newton-triangular). rowscan_has_w=False
        promises that every w offset is zero (as bench.py passes for DHFR),
        and so does quad_has_w=False for the quad MD provider (JAX's
        configure_pallas takes the same two)."""
        if kernel not in ("rowscan", "gather", "quad", "dot", "v1"):
            raise ValueError(f"kernel must be 'rowscan', 'gather', 'quad', 'dot' or 'v1', got {kernel!r}")
        box = torch.as_tensor(box, device=self.params.device)
        conf = torch.as_tensor(conf, device=self.params.device)
        if kernel == "quad" and not qk.constant_shift_valid(conf, box, self.cutoff + SKIN):
            kernel = "rowscan"
        self.dot_sort = None
        if kernel == "dot":
            valid = (s for s in ("snake", "hilbert") if dk.dotscan_valid(conf, box, self.cutoff + SKIN, sort=s))
            self.dot_sort = next(valid, None)
            if self.dot_sort is None:
                kernel = "rowscan"
        self.kernel = kernel
        self.dp_max_tiles = nbk.suggest_max_tiles(conf, box, self.cutoff, margin=MARGIN, cb=DP_CB, triangular=True)
        self.h_coeffs = rs.es_energy_force_series(self.beta, self.cutoff)[0]
        if kernel == "gather":
            self.max_nbrs = gk.suggest_max_nbrs(conf, box, self.cutoff, margin=MARGIN)
            ef = gk.make_nonbonded_gather_energy_force(self.beta, self.cutoff, self.max_nbrs)
            self._energy = lambda x, params, box: ef(x, params, box)[0]
            self._energy_force = ef
            self._u = gk.make_nonbonded_gather(self.beta, self.cutoff, self.max_nbrs, self.dp_max_tiles, dp_cb=DP_CB)
            self.md_max_nbrs = gk.suggest_max_nbrs(conf, box, self.cutoff + SKIN, margin=MARGIN)
            self._md = gk.make_nonbonded_gather_md(
                self.beta, self.cutoff, self.md_max_nbrs, skin=SKIN, rebuild_interval=REBUILD_INTERVAL
            )
        elif kernel in ("rowscan", "quad", "dot"):
            pairs = rs.suggest_max_pairs(conf, box, self.cutoff, margin=MARGIN, triangular=True)
            ef = rs.make_nonbonded_rowscan_energy_force(self.beta, self.cutoff, pairs)
            self._energy = lambda x, params, box: ef(x, params, box, rs.ENERGY)[0]
            self._energy_force = ef
            self._u = rs.make_nonbonded_rowscan(self.beta, self.cutoff, pairs, self.dp_max_tiles, dp_cb=DP_CB)
            self.max_pairs = pairs
            if kernel == "quad":
                self.md_max_tiles = qk.suggest_max_tiles(conf, box, self.cutoff + SKIN, margin=MARGIN)
                self._md = qk.make_nonbonded_quadscan_md(
                    self.beta, self.cutoff, self.md_max_tiles, skin=SKIN, rebuild_interval=REBUILD_INTERVAL,
                    has_w=quad_has_w,
                )
            elif kernel == "dot":
                self.md_max_pairs = dk.suggest_max_pairs(
                    conf, box, self.cutoff + SKIN, margin=MARGIN, triangular=True, sort=self.dot_sort
                )
                self._md = dk.make_nonbonded_dotscan_md(
                    self.beta, self.cutoff, self.md_max_pairs, skin=SKIN, rebuild_interval=REBUILD_INTERVAL,
                    sort=self.dot_sort,
                )
            else:
                cell = 0.65
                if conf.shape[0] >= 8192:
                    cell = rs.suggest_cell_size(conf, box, self.cutoff, skin=SKIN)
                md_pairs = rs.suggest_max_pairs(
                    conf, box, self.cutoff + SKIN, margin=MARGIN, cell_size=cell, triangular=True
                )
                preshift = dk.dotscan_valid(conf, box, self.cutoff + SKIN, cell_size=cell)
                self._md = rs.make_nonbonded_rowscan_md(
                    self.beta, self.cutoff, md_pairs, skin=SKIN, rebuild_interval=REBUILD_INTERVAL, cell_size=cell,
                    preshift=preshift, has_w=rowscan_has_w,
                )
                self.md_max_pairs, self.md_cell_size, self.md_preshift = md_pairs, cell, preshift
        else:
            ef = nbk.make_nonbonded_tiles_energy_force(self.beta, self.cutoff, self.dp_max_tiles, cb=DP_CB)
            self._energy = lambda x, params, box: ef(x, params, box)[0]
            self._energy_force = ef
            self._u = nbk.make_nonbonded_tiles(self.beta, self.cutoff, self.dp_max_tiles, cb=DP_CB)
            self.md_max_tiles = nbk.suggest_max_tiles(
                conf, box, self.cutoff + SKIN, margin=MARGIN, cb=DP_CB, triangular=True
            )
            self._md = nbk.make_nonbonded_tiles_md(
                self.beta, self.cutoff, self.md_max_tiles, skin=SKIN, rebuild_interval=REBUILD_INTERVAL, cb=DP_CB
            )
            self.h_coeffs = None
        return self

    def _configured(self):
        if self._u is None:
            raise RuntimeError(f"{type(self).__name__}: call configure(box, conf) first")

    def u(self, x, params, box):
        """Energy as a function of (x, params, box), differentiable in x and
        params (the counterpart of the JAX potential's __call__)."""
        self._configured()
        return self._u(x, params, box)

    def energy(self, x, box):
        self._configured()
        return self._energy(x, self.params, box)

    def energy_force(self, x, box):
        self._configured()
        return self._energy_force(x, self.params, box)

    def md_force_provider(self):
        """(init(x, box), apply(state, x, box, t) -> (force, state),
        energy(state, x, box), rigid_energy(state, x, box)); the energies
        reuse the state's lists."""
        self._configured()
        init, apply, energy = self._md

        def init_fn(x, box):
            return init(x, self.params, box)

        def apply_fn(state, x, box, t):
            return apply(state, x, self.params, box, t)

        def energy_fn(state, x, box):
            return energy(state, x, self.params, box)

        return init_fn, apply_fn, energy_fn, energy_fn


class Nonbonded(NonbondedAllPairs):
    """All pairs minus the intramolecular exclusions, which are subtracted
    with the sweep's own electrostatics so they cancel it: the rowscan
    polynomial in closed form, or exact erfc through autograd (kernel="v1").
    Leading TIP3P waters go through a strided path, the rest through an
    explicit pair list."""

    def __init__(
        self, num_atoms: int, exclusion_idxs, scale_factors, beta: float, cutoff: float, params,
        device=None, dtype=torch.float64,
    ):
        super().__init__(num_atoms, beta, cutoff, params, device=device, dtype=dtype)
        device = self.params.device
        exc = np.ascontiguousarray(exclusion_idxs, dtype=np.int64).reshape(-1, 2)
        scales = np.ascontiguousarray(scale_factors, dtype=np.float64).reshape(-1, 2)
        self.num_waters = nonbonded.leading_water_exclusions(exc, scales)
        tail = exc[3 * self.num_waters :]
        self.register_buffer("tail_idxs", torch.tensor(tail, device=device))
        self.register_buffer("tail_scales", torch.tensor(scales[3 * self.num_waters :], device=device, dtype=dtype))
        self.assemble = SegmentSum(tail.T.ravel(), num_atoms, device=device)

    def exclusion_energy(self, x, params, box):
        """u_exc as a function of (x, params, box), differentiable in both."""
        if self.h_coeffs is not None:
            return self._exclusion_energy_force_poly(x, params, box)[0]
        u = x.new_zeros(())
        if self.num_waters:
            u = nonbonded.water_exclusion_energy(x, params, box, self.num_waters, self.beta, self.cutoff)
        if self.tail_idxs.shape[0]:
            vdw, es = nonbonded.nonbonded_on_specific_pairs(
                x, params, box, self.tail_idxs, self.beta, self.cutoff, self.tail_scales.to(params.dtype)
            )
            u = u + torch.sum(vdw) + torch.sum(es)
        return u

    def _exclusion_energy_force_poly(self, x, params, box):
        u, grad = x.new_zeros(()), torch.zeros_like(x)
        if self.num_waters:
            u, grad = nonbonded.water_exclusion_energy_force(x, params, box, self.num_waters, self.cutoff, self.h_coeffs)
        if self.tail_idxs.shape[0]:
            u_t, f_t = nonbonded.specific_pairs_energy_force(
                x, params, box, self.tail_idxs, self.cutoff, self.tail_scales.to(params.dtype), self.h_coeffs,
                self.assemble,
            )
            u, grad = u + u_t, grad - f_t
        return u, grad

    def exclusion_energy_force(self, x, box):
        """(u_exc, dU_exc/dx) of the excluded pairs: closed form with the
        rowscan polynomial, autograd with exact erfc."""
        if self.h_coeffs is not None:
            return self._exclusion_energy_force_poly(x, self.params, box)
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            u = self.exclusion_energy(xg, self.params, box)
            (grad,) = torch.autograd.grad(u, xg)
        return u.detach(), grad

    def u(self, x, params, box):
        return super().u(x, params, box) - self.exclusion_energy(x, params, box)

    def energy(self, x, box):
        return super().energy(x, box) - self.exclusion_energy_force(x, box)[0]

    def energy_force(self, x, box):
        u, f = super().energy_force(x, box)
        u_exc, g_exc = self.exclusion_energy_force(x, box)
        return u - u_exc, f + g_exc

    def md_force_provider(self):
        """As NonbondedAllPairs', with the exclusions subtracted in the force
        and in the energy. The rigid energy (4th) is all-pairs only: in a
        rigid move the bond-graph-local exclusions cancel exactly, and
        leaving them out avoids f32 cancellation of their large sums."""
        init_fn, apply_ap, energy_ap, _ = super().md_force_provider()

        def apply_fn(state, x, box, t):
            f, state = apply_ap(state, x, box, t)
            return f + self.exclusion_energy_force(x, box)[1], state

        def energy_fn(state, x, box):
            return energy_ap(state, x, box) - self.exclusion_energy_force(x, box)[0]

        return init_fn, apply_fn, energy_fn, energy_ap
