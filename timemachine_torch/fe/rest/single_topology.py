"""REST2-flavoured single topology: at intermediate λ the selected
interactions are attenuated so that barriers melt where the transformation
happens (counterpart of timemachine_tpu/fe/rest/single_topology.py).

The hot (REST) region grows from the atoms whose bonded parameters differ
between the end states, plus every dummy atom: whole rings that touch them,
then pendant decorations (terminal atoms and two-atom chains such as a
hydroxyl). Propers whose central bond is rotatable or in an aliphatic ring
and that touch the region, and the region's rows of the ligand's pair list
and of the host-guest interaction group (charge and sqrt(epsilon)), are
multiplied by 1 / T(λ): T a symmetric schedule of the effective temperature
scale, 1 at the end states and max_temperature_scale at λ = 0.5.

The scaled tables are torch float64 copies: the parent's aligned tables and
the states it returns are left as they are.
"""

from __future__ import annotations

from dataclasses import replace
from functools import cached_property

import numpy as np
import torch

from timemachine_torch.constants import NBParamIdx
from timemachine_torch.fe.rest.bond import mkbond, mkproper
from timemachine_torch.fe.rest.interpolation import InterpolationFxnName, Schedule, Symmetric
from timemachine_torch.fe.rest.queries import get_aliphatic_ring_bonds, get_rotatable_bonds
from timemachine_torch.fe.single_topology import AtomMapFlags, SingleTopology
from timemachine_torch.ff.handlers import as_f64


def grow_rest_region(mol, seed_atoms) -> set:
    """Seeds -> every ring holding a seed -> pendant decorations: a
    terminal atom bonded to the region joins it, and so does a degree-2 atom
    that bridges the region to a terminal atom, with that atom."""
    seeds = set(int(a) for a in seed_atoms)
    ringed = set(seeds)
    for ring in mol.ring_info():
        if seeds & set(ring):
            ringed |= set(int(a) for a in ring)

    pendants = set()
    for atom in range(mol.num_atoms):
        nbs = mol.neighbors(atom)
        if len(nbs) == 1 and nbs[0] in ringed:
            pendants.add(atom)
        elif len(nbs) == 2:
            far = None
            if nbs[0] in ringed:
                far = nbs[1]
            elif nbs[1] in ringed:
                far = nbs[0]
            if far is not None and len(mol.neighbors(far)) == 1:
                pendants.add(atom)
                pendants.add(far)
    return ringed | pendants


def _scale_entries(params: torch.Tensor, rows, cols, scale: float) -> torch.Tensor:
    """A copy of params with params[rows, c] * scale for each c in cols,
    every other entry bitwise unchanged."""
    factor = torch.ones_like(params)
    rows = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=params.device)
    for c in cols:
        factor[rows, c] = scale
    return params * factor


class SingleTopologyREST(SingleTopology):
    """SingleTopology whose intermediate states run the REST region hot."""

    def __init__(
        self,
        mol_a,
        mol_b,
        core: np.ndarray,
        forcefield,
        max_temperature_scale: float,
        temperature_scale_interpolation: InterpolationFxnName = "exponential",
    ):
        super().__init__(mol_a, mol_b, core, forcefield)
        self.max_temperature_scale = max_temperature_scale
        self._temperature_scale = Symmetric(Schedule(temperature_scale_interpolation, 1.0, max_temperature_scale))

    # -- the region -------------------------------------------------------------

    @cached_property
    def _perturbed_atom_idxs(self) -> set:
        """Combined atoms of a bond, angle or improper whose parameters differ
        between the end states, and every dummy atom."""
        seeds: set[int] = set()
        for table in (self.aligned_bond, self.aligned_angle, self.aligned_improper):
            src = np.asarray(table.src_params)
            dst = np.asarray(table.dst_params)
            changed = ~np.all(src == dst, axis=tuple(range(1, src.ndim)))
            seeds.update(int(i) for i in np.asarray(table.idxs)[changed].reshape(-1))
        return seeds | self.get_dummy_atoms_a() | self.get_dummy_atoms_b()

    def split_combined_idxs(self, combined_idxs):
        """Combined indices -> (mol_a indices, mol_b indices)."""
        idxs_a = [self.c_to_a[i] for i in combined_idxs if self.c_flags[i] != AtomMapFlags.MOL_B]
        idxs_b = [self.c_to_b[i] for i in combined_idxs if self.c_flags[i] != AtomMapFlags.MOL_A]
        return idxs_a, idxs_b

    @cached_property
    def rest_region_atom_idxs(self) -> set:
        """The hot region in combined indices: the seeds grown in each end
        state's molecule and mapped back."""
        seeds_a, seeds_b = self.split_combined_idxs(self._perturbed_atom_idxs)
        region_a = grow_rest_region(self.mol_a, seeds_a)
        region_b = grow_rest_region(self.mol_b, seeds_b)
        return {int(self.a_to_c[i]) for i in region_a} | {int(self.b_to_c[i]) for i in region_b}

    @property
    def base_rest_region_atom_idxs(self) -> set:
        return self._perturbed_atom_idxs

    # -- the targeted propers ---------------------------------------------------

    @cached_property
    def _softenable_bonds(self) -> set:
        """Rotatable and aliphatic-ring bonds of both molecules, combined indices."""
        bonds = set()
        for mol, to_c in ((self.mol_a, self.a_to_c), (self.mol_b, self.b_to_c)):
            for bond in get_rotatable_bonds(mol) | get_aliphatic_ring_bonds(mol):
                bonds.add(bond.translate(to_c))
        return bonds

    @cached_property
    def propers(self) -> list:
        return [tuple(int(i) for i in row) for row in self.aligned_proper.idxs]

    @cached_property
    def target_proper_idxs(self) -> list:
        """Rows of the proper table to attenuate: a softenable central bond
        and an atom in the hot region."""
        region = self.rest_region_atom_idxs
        soft = self._softenable_bonds
        return [
            row
            for row, idxs in enumerate(self.propers)
            if mkbond(idxs[1], idxs[2]) in soft and any(i in region for i in idxs)
        ]

    @cached_property
    def target_propers(self) -> dict:
        return {row: mkproper(*self.propers[row]) for row in self.target_proper_idxs}

    # -- the scaling ------------------------------------------------------------

    def get_energy_scale_factor(self, lamb: float) -> float:
        return 1.0 / float(self._temperature_scale(lamb))

    def hot_pair_rows(self, pair_idxs) -> np.ndarray:
        """Rows of a ligand pair list (P, 2) with an atom in the hot region."""
        region = self.rest_region_atom_idxs
        return np.flatnonzero(np.array([(int(i) in region) or (int(j) in region) for i, j in np.asarray(pair_idxs)], dtype=bool))

    def setup_intermediate_state(self, lamb: float):
        state = super().setup_intermediate_state(lamb)
        scale = self.get_energy_scale_factor(lamb)
        proper_params = _scale_entries(as_f64(state.proper.params), self.target_proper_idxs, (0,), scale)
        hot_rows = self.hot_pair_rows(state.nonbonded_pair_list.potential.idxs)
        pair_params = _scale_entries(
            as_f64(state.nonbonded_pair_list.params), hot_rows, (NBParamIdx.Q_IDX, NBParamIdx.LJ_EPS_IDX), scale
        )
        return replace(
            state,
            proper=state.proper.potential.bind(proper_params),
            nonbonded_pair_list=state.nonbonded_pair_list.potential.bind(pair_params),
        )

    def combine_with_host(self, host_system, lamb: float, num_water_atoms: int, ff, host_topology=None):
        """Also attenuates the hot region's rows of the host-guest
        interaction group (the ligand's side, which keeps a water sampler's
        parameters coherent)."""
        state = super().combine_with_host(host_system, lamb, num_water_atoms, ff, host_topology)
        scale = self.get_energy_scale_factor(lamb)
        n_host = host_system.nonbonded_all_pairs.potential.num_atoms
        hot_rows = np.array(sorted(self.rest_region_atom_idxs), dtype=int) + n_host
        ixn_params = _scale_entries(
            as_f64(state.nonbonded_ixn_group.params), hot_rows, (NBParamIdx.Q_IDX, NBParamIdx.LJ_EPS_IDX), scale
        )
        return replace(state, nonbonded_ixn_group=state.nonbonded_ixn_group.potential.bind(ixn_params))
