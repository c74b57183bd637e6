"""Potentials of the host system as `nn.Module`s
(counterpart of timemachine_tpu/potentials.py).

Each module holds its index and parameter buffers (a JAX BoundPotential's
potential + params) and offers

  energy(x, box) -> u
  energy_force(x, box) -> (u, force),  force = -dU/dx, closed form

Bonded terms sum their per-term forces with a fixed-order SegmentSum, so a
step is bitwise reproducible on the card. `Nonbonded` also offers the
stateful MD provider the Context uses (`md_force_provider`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from timemachine_torch.ops import bonded, nonbonded
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.ops.segment import SegmentSum

# list capacity over the count at configure time, the MD lists' skin (nm)
# and their rebuild period (steps), as the JAX package's rowscan path
MARGIN, SKIN, REBUILD_INTERVAL = 1.4, 0.1, 20


class _BondedTerm(nn.Module):
    """Shared shape of the valence terms: idxs (T, k) atoms, params (T, 3|2)."""

    # bond-graph-local: a rigid per-molecule move (the barostat's) leaves the
    # energy unchanged, so volume moves skip the term
    rigid_group_invariant = True

    def __init__(self, idxs, params, num_atoms: int, device=None, dtype=torch.float64):
        super().__init__()
        idxs = np.ascontiguousarray(idxs, dtype=np.int64)
        if idxs.size and (idxs.min() < 0 or idxs.max() >= num_atoms):
            raise ValueError(f"{type(self).__name__}: atom index out of range")
        self.register_buffer("idxs", torch.tensor(idxs, device=device))
        self.register_buffer("params", torch.tensor(np.ascontiguousarray(params), device=device, dtype=dtype))
        # role-major: contributions arrive as cat([role 0 rows, role 1 rows, ...])
        self.assemble = SegmentSum(idxs.T.ravel(), num_atoms, device=device)

    def energy(self, x, box):
        return type(self)._energy(x, self.params, box, self.idxs)

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
    """All-pairs LJ + switched Coulomb in 4D, no exclusions, through the
    rowscan sweep. Call `configure(box, conf)` once before use: it sizes the
    list capacities from the geometry."""

    rigid_group_invariant = False

    def __init__(self, num_atoms: int, beta: float, cutoff: float, params, device=None, dtype=torch.float64):
        super().__init__()
        self.num_atoms = num_atoms
        self.beta = float(beta)
        self.cutoff = float(cutoff)
        self.register_buffer("params", torch.tensor(np.ascontiguousarray(params), device=device, dtype=dtype))
        self.h_coeffs = rs.es_energy_force_series(self.beta, self.cutoff)[0]
        self._ef = None
        self._md = None

    def configure(self, box, conf):
        """Size the lists from this geometry: max_pairs at MARGIN over the
        present count, and for the MD provider a sort-cell size from a census
        of swept slots (systems of 8,192 atoms and up)."""
        box = torch.as_tensor(box, device=self.params.device)
        conf = torch.as_tensor(conf, device=self.params.device)
        pairs = rs.suggest_max_pairs(conf, box, self.cutoff, margin=MARGIN)
        self._ef = rs.make_nonbonded_rowscan_energy_force(self.beta, self.cutoff, pairs)
        cell = 0.65
        if conf.shape[0] >= 8192:
            cell = rs.suggest_cell_size(conf, box, self.cutoff, skin=SKIN)
        md_pairs = rs.suggest_max_pairs(conf, box, self.cutoff + SKIN, margin=MARGIN, cell_size=cell)
        self._md = rs.make_nonbonded_rowscan_md(
            self.beta, self.cutoff, md_pairs, skin=SKIN, rebuild_interval=REBUILD_INTERVAL, cell_size=cell
        )
        self.max_pairs, self.md_max_pairs, self.md_cell_size = pairs, md_pairs, cell
        return self

    def _configured(self):
        if self._ef is None:
            raise RuntimeError(f"{type(self).__name__}: call configure(box, conf) first")

    def energy(self, x, box):
        self._configured()
        return self._ef(x, self.params, box, rs.ENERGY)[0]

    def energy_force(self, x, box):
        self._configured()
        return self._ef(x, self.params, box)

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
    with the sweep's own polynomial electrostatics so they cancel it exactly.
    Leading TIP3P waters go through a strided path, the rest through an
    explicit pair list."""

    def __init__(
        self, num_atoms: int, exclusion_idxs, scale_factors, beta: float, cutoff: float, params,
        device=None, dtype=torch.float64,
    ):
        super().__init__(num_atoms, beta, cutoff, params, device=device, dtype=dtype)
        exc = np.ascontiguousarray(exclusion_idxs, dtype=np.int64).reshape(-1, 2)
        scales = np.ascontiguousarray(scale_factors, dtype=np.float64).reshape(-1, 2)
        self.num_waters = nonbonded.leading_water_exclusions(exc, scales)
        tail = exc[3 * self.num_waters :]
        self.register_buffer("tail_idxs", torch.tensor(tail, device=device))
        self.register_buffer("tail_scales", torch.tensor(scales[3 * self.num_waters :], device=device, dtype=dtype))
        self.assemble = SegmentSum(tail.T.ravel(), num_atoms, device=device)

    def exclusion_energy_force(self, x, box):
        """(u_exc, dU_exc/dx) of the excluded pairs."""
        u, grad = x.new_zeros(()), torch.zeros_like(x)
        if self.num_waters:
            u, grad = nonbonded.water_exclusion_energy_force(
                x, self.params, box, self.num_waters, self.cutoff, self.h_coeffs
            )
        if self.tail_idxs.shape[0]:
            u_t, f_t = nonbonded.specific_pairs_energy_force(
                x, self.params, box, self.tail_idxs, self.cutoff, self.tail_scales, self.h_coeffs, self.assemble
            )
            u, grad = u + u_t, grad - f_t
        return u, grad

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
