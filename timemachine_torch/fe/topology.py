"""Topology parameterizers: mol + forcefield -> bound potentials.

The port of BaseTopology, get_ligand_ixn_pots_params and
exclude_all_ligand_ligand_ixns of timemachine_tpu/fe/topology.py (its
DualTopology and HostGuestTopology are not ported yet). The guest
intramolecular nonbonded term is a precomputed pair list; guest-environment
coupling is an interaction group; the host keeps its AllPairs term with the
guest atoms masked out via atom_idxs. Parameters are torch f64 (fe/terms.py)."""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch.constants import (
    DEFAULT_CHIRAL_ATOM_RESTRAINT_K,
    DEFAULT_CHIRAL_BOND_RESTRAINT_K,
)
from timemachine_torch.fe import chiral_utils
from timemachine_torch.fe import terms as potentials
from timemachine_torch.fe.terms import GuestTerms
from timemachine_torch.fe.utils import get_romol_conf
from timemachine_torch.ff import Forcefield
from timemachine_torch.ff.handlers import as_f64, generate_exclusion_idxs
from timemachine_torch.ops.nonbonded import combine_epsilon, combine_sigma

_SCALE_12 = 1.0
_SCALE_13 = 1.0
_SCALE_14_LJ = 0.5
_SCALE_14_Q = 0.5

_BETA = 2.0
_CUTOFF = 1.2


class AtomMappingError(Exception):
    pass


class UnsupportedPotential(Exception):
    pass


class BaseTopology:
    """Single-ligand parameterizer (ref topology.py:239-481)."""

    def __init__(self, mol, forcefield: Forcefield):
        self.mol = mol
        self.ff = forcefield

    def get_num_atoms(self):
        return self.mol.num_atoms

    def get_component_idxs(self):
        return [np.arange(self.get_num_atoms())]

    def parameterize_nonbonded(
        self, ff_q_params, ff_q_params_intra, ff_lj_params, ff_lj_params_intra, lamb: float, intramol_params=True
    ):
        if intramol_params:
            q_params = self.ff.q_handle_intra.partial_parameterize(ff_q_params_intra, self.mol)
            lj_params = self.ff.lj_handle_intra.partial_parameterize(ff_lj_params_intra, self.mol)
        else:
            q_params = self.ff.q_handle.partial_parameterize(ff_q_params, self.mol)
            lj_params = self.ff.lj_handle.partial_parameterize(ff_lj_params, self.mol)

        exclusion_idxs, scale_factors = generate_exclusion_idxs(
            self.mol, scale12=_SCALE_12, scale13=_SCALE_13, scale14_lj=_SCALE_14_LJ, scale14_q=_SCALE_14_Q
        )
        n = len(q_params)
        nb = potentials.Nonbonded(n, exclusion_idxs, scale_factors, _BETA, _CUTOFF)
        w_coords = lamb * _CUTOFF * torch.ones((n, 1), dtype=torch.float64)
        params = torch.cat([as_f64(q_params).reshape(-1, 1), as_f64(lj_params).reshape(-1, 2), w_coords], dim=1)
        return params, nb

    def parameterize_nonbonded_pairlist(
        self, ff_q_params, ff_q_params_intra, ff_lj_params, ff_lj_params_intra, intramol_params=True
    ):
        """All intramolecular pairs not fully excluded, with pre-combined
        params (ref topology.py:298-367)."""
        exclusion_idxs, scale_factors = generate_exclusion_idxs(
            self.mol, scale12=_SCALE_12, scale13=_SCALE_13, scale14_lj=_SCALE_14_LJ, scale14_q=_SCALE_14_Q
        )
        exclusions_kv = {(int(i), int(j)): sf for (i, j), sf in zip(exclusion_idxs, scale_factors)}

        inclusion_idxs, rescale_mask = [], []
        n = self.mol.num_atoms
        for i in range(n):
            for j in range(i + 1, n):
                scale_factor = exclusions_kv.get((i, j), np.zeros(2))
                rescale = 1 - np.asarray(scale_factor, dtype=np.float64)
                if np.any(rescale) > 0:
                    rescale_mask.append(rescale)
                    inclusion_idxs.append([i, j])
        inclusion_idxs = np.array(inclusion_idxs, dtype=np.int32).reshape(-1, 2)

        if intramol_params:
            q_params = self.ff.q_handle_intra.partial_parameterize(ff_q_params_intra, self.mol)
            lj_params = self.ff.lj_handle_intra.partial_parameterize(ff_lj_params_intra, self.mol)
        else:
            q_params = self.ff.q_handle.partial_parameterize(ff_q_params, self.mol)
            lj_params = self.ff.lj_handle.partial_parameterize(ff_lj_params, self.mol)

        q_params, lj_params = as_f64(q_params), as_f64(lj_params)
        l_idxs, r_idxs = (torch.as_tensor(inclusion_idxs[:, k], dtype=torch.int64) for k in (0, 1))
        q_ij = q_params[l_idxs] * q_params[r_idxs]
        sig_ij = combine_sigma(lj_params[l_idxs, 0], lj_params[r_idxs, 0])
        eps_ij = combine_epsilon(lj_params[l_idxs, 1], lj_params[r_idxs, 1])
        rescale_arr = as_f64(np.array(rescale_mask).reshape(-1, 2))
        params = torch.stack(
            [
                q_ij * rescale_arr[:, 0],
                sig_ij,
                eps_ij * rescale_arr[:, 1],
                torch.zeros(len(inclusion_idxs), dtype=torch.float64),
            ],
            dim=1,
        ) if len(inclusion_idxs) else torch.zeros((0, 4), dtype=torch.float64)

        return params, potentials.NonbondedPairListPrecomputed(inclusion_idxs, _BETA, _CUTOFF)

    def parameterize_harmonic_bond(self, ff_params):
        params, idxs = self.ff.hb_handle.partial_parameterize(ff_params, self.mol)
        return params, potentials.HarmonicBond(idxs)

    def parameterize_harmonic_angle(self, ff_params):
        params, idxs = self.ff.ha_handle.partial_parameterize(ff_params, self.mol)
        return params, potentials.HarmonicAngle(idxs)

    def parameterize_proper_torsion(self, ff_params):
        params, idxs = self.ff.pt_handle.partial_parameterize(ff_params, self.mol)
        return params, potentials.PeriodicTorsion(idxs)

    def parameterize_improper_torsion(self, ff_params):
        params, idxs = self.ff.it_handle.partial_parameterize(ff_params, self.mol)
        return params, potentials.PeriodicTorsion(idxs)

    def setup_chiral_restraints(
        self, chiral_atom_restraint_k=DEFAULT_CHIRAL_ATOM_RESTRAINT_K, chiral_bond_restraint_k=DEFAULT_CHIRAL_BOND_RESTRAINT_K
    ):
        """(ref topology.py:384-433)"""
        mol = self.mol
        conf = get_romol_conf(mol)

        atom_idxs = np.array(chiral_utils.setup_all_chiral_atom_restr_idxs(mol, conf), np.int32).reshape(-1, 4)
        atom_params = chiral_atom_restraint_k * np.ones(len(atom_idxs))
        chiral_atom_potential = potentials.ChiralAtomRestraint(atom_idxs).bind(atom_params)

        bond_idxs_list, bond_signs, bond_params = [], [], []
        for src, dst in sorted(chiral_utils.find_chiral_bonds(mol)):
            idxs, signs = chiral_utils.setup_chiral_bond_restraints(mol, conf, src, dst)
            for ii in idxs:
                assert ii not in bond_idxs_list
            bond_idxs_list.extend(idxs)
            bond_signs.extend(signs)
            bond_params.extend(chiral_bond_restraint_k for _ in idxs)
        bond_idxs = np.array(bond_idxs_list, dtype=np.int32).reshape(-1, 4)
        chiral_bond_potential = potentials.ChiralBondRestraint(bond_idxs, np.array(bond_signs, dtype=np.int32)).bind(
            np.array(bond_params)
        )
        return chiral_atom_potential, chiral_bond_potential

    def setup_end_state(self) -> GuestTerms:
        """(ref topology.py:448-481)"""
        bond_params, hb = self.parameterize_harmonic_bond(self.ff.hb_handle.params)
        angle_params, ha = self.parameterize_harmonic_angle(self.ff.ha_handle.params)
        proper_params, pt = self.parameterize_proper_torsion(self.ff.pt_handle.params)
        improper_params, it = self.parameterize_improper_torsion(self.ff.it_handle.params)
        nbpl_params, nbpl = self.parameterize_nonbonded_pairlist(
            self.ff.q_handle.params,
            self.ff.q_handle_intra.params,
            self.ff.lj_handle.params,
            self.ff.lj_handle_intra.params,
            intramol_params=True,
        )
        empty_atom = potentials.ChiralAtomRestraint(np.zeros((0, 4), dtype=np.int32)).bind(np.zeros(0))
        empty_bond = potentials.ChiralBondRestraint(np.zeros((0, 4), dtype=np.int32), np.zeros(0, dtype=np.int32)).bind(
            np.zeros(0)
        )
        return GuestTerms(
            bond=hb.bind(bond_params),
            angle=ha.bind(angle_params),
            proper=pt.bind(proper_params),
            improper=it.bind(improper_params),
            chiral_atom=empty_atom,
            chiral_bond=empty_bond,
            nonbonded_pair_list=nbpl.bind(nbpl_params),
        )

    def setup_chiral_end_state(self) -> GuestTerms:
        system = self.setup_end_state()
        chiral_atom, chiral_bond = self.setup_chiral_restraints()
        system.chiral_atom = chiral_atom
        system.chiral_bond = chiral_bond
        return system


def exclude_all_ligand_ligand_ixns(num_host_atoms: int, num_guest_atoms: int):
    """(ref topology.py:666-683)"""
    guest_exclusions = []
    guest_scale_factors = []
    for i in range(num_guest_atoms):
        for j in range(i + 1, num_guest_atoms):
            guest_exclusions.append((i, j))
            guest_scale_factors.append((1.0, 1.0))
    return (
        np.array(guest_exclusions, dtype=np.int32) + num_host_atoms,
        np.array(guest_scale_factors, dtype=np.float64),
    )


def get_ligand_ixn_pots_params(lig_idxs, env_idxs, host_nb_params, guest_params_ixn_env, beta=2.0, cutoff=1.2):
    """Ligand-environment interaction group potential + params
    (ref topology.py:685-730)."""
    env_idxs = env_idxs if env_idxs is not None else np.array([], dtype=np.int32)
    num_total = len(lig_idxs) + len(env_idxs)
    pot = potentials.NonbondedInteractionGroup(num_total, lig_idxs, beta, cutoff, col_atom_idxs=env_idxs)
    params = torch.cat([as_f64(host_nb_params), as_f64(guest_params_ixn_env)])
    return pot, params
