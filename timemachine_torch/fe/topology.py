"""Topology parameterizers: mol + forcefield -> bound potentials.

The port of timemachine_tpu/fe/topology.py: BaseTopology, DualTopology (two
ligands, their mutual interactions excluded), HostGuestTopology (a host's
potentials combined with a guest topology's), get_ligand_ixn_pots_params and
exclude_all_ligand_ligand_ixns. The guest
intramolecular nonbonded term is a precomputed pair list; guest-environment
coupling is an interaction group; the host keeps its AllPairs term with the
guest atoms masked out via atom_idxs. Parameters are torch f64 (fe/terms.py)."""

from __future__ import annotations

import numpy as np
import torch

from typing import Any

from timemachine_torch.constants import (
    DEFAULT_CHIRAL_ATOM_RESTRAINT_K,
    DEFAULT_CHIRAL_BOND_RESTRAINT_K,
    NBParamIdx,
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


class DualTopology(BaseTopology):
    """Two ligands, mutual interactions fully excluded (ref topology.py:484-663)."""

    def __init__(self, mol_a, mol_b, forcefield: Forcefield):
        self.mol_a = mol_a
        self.mol_b = mol_b
        self.ff = forcefield

    def get_num_atoms(self):
        return self.mol_a.num_atoms + self.mol_b.num_atoms

    def get_component_idxs(self):
        na, nb = self.mol_a.num_atoms, self.mol_b.num_atoms
        return [np.arange(na), na + np.arange(nb)]

    def _parameterize_nonbonded(self, ff_q_params, ff_q_params_intra, ff_lj_params, ff_lj_params_intra, intramol_params=True):
        if intramol_params:
            q_handle, lj_handle, q_p, lj_p = self.ff.q_handle_intra, self.ff.lj_handle_intra, ff_q_params_intra, ff_lj_params_intra
        else:
            q_handle, lj_handle, q_p, lj_p = self.ff.q_handle, self.ff.lj_handle, ff_q_params, ff_lj_params
        q_params = torch.cat([as_f64(q_handle.partial_parameterize(q_p, m)) for m in (self.mol_a, self.mol_b)])
        lj_params = torch.cat([as_f64(lj_handle.partial_parameterize(lj_p, m)) for m in (self.mol_a, self.mol_b)])

        excl_a, scale_a = generate_exclusion_idxs(self.mol_a, _SCALE_12, _SCALE_13, _SCALE_14_LJ, _SCALE_14_Q)
        excl_b, scale_b = generate_exclusion_idxs(self.mol_b, _SCALE_12, _SCALE_13, _SCALE_14_LJ, _SCALE_14_Q)

        na, nb = self.mol_a.num_atoms, self.mol_b.num_atoms
        mutual = np.array([[i, j + na] for i in range(na) for j in range(nb)], dtype=np.int32)
        mutual_scales = np.ones((len(mutual), 2))

        combined_excl = np.concatenate([excl_a, excl_b + na, mutual]).astype(np.int32)
        combined_scales = np.concatenate([scale_a, scale_b, mutual_scales]).astype(np.float64)

        n = na + nb
        qlj = torch.cat(
            [q_params.reshape(-1, 1), lj_params.reshape(-1, 2), torch.zeros((n, 1), dtype=torch.float64)], dim=1
        )
        return qlj, potentials.Nonbonded(n, combined_excl, combined_scales, _BETA, _CUTOFF)

    def parameterize_nonbonded(
        self, ff_q_params, ff_q_params_intra, ff_lj_params, ff_lj_params_intra, lamb: float, intramol_params=True
    ):
        params, nb = self._parameterize_nonbonded(
            ff_q_params, ff_q_params_intra, ff_lj_params, ff_lj_params_intra, intramol_params=intramol_params
        )
        params = params.clone()
        params[:, NBParamIdx.W_IDX] = lamb * nb.cutoff
        return params, nb

    def parameterize_nonbonded_pairlist(
        self, ff_q_params, ff_q_params_intra, ff_lj_params, ff_lj_params_intra, intramol_params=True
    ):
        na = self.mol_a.num_atoms
        params_a, pl_a = BaseTopology(self.mol_a, self.ff).parameterize_nonbonded_pairlist(
            ff_q_params, ff_q_params_intra, ff_lj_params, ff_lj_params_intra, intramol_params
        )
        params_b, pl_b = BaseTopology(self.mol_b, self.ff).parameterize_nonbonded_pairlist(
            ff_q_params, ff_q_params_intra, ff_lj_params, ff_lj_params_intra, intramol_params
        )
        params = torch.cat([params_a, params_b])
        idxs = np.concatenate([pl_a.idxs, pl_b.idxs + na])
        assert pl_a.beta == pl_b.beta and pl_a.cutoff == pl_b.cutoff
        return params, potentials.NonbondedPairListPrecomputed(idxs, pl_a.beta, pl_a.cutoff)

    def _parameterize_bonded_term(self, ff_params, handle, potential_ctor):
        offset = self.mol_a.num_atoms
        params_a, idxs_a = handle.partial_parameterize(ff_params, self.mol_a)
        params_b, idxs_b = handle.partial_parameterize(ff_params, self.mol_b)
        params = torch.cat([as_f64(params_a), as_f64(params_b)])
        idxs = np.concatenate([idxs_a, idxs_b + offset]) if len(idxs_b) else np.asarray(idxs_a)
        return params, potential_ctor(idxs.astype(np.int32))

    def parameterize_harmonic_bond(self, ff_params):
        return self._parameterize_bonded_term(ff_params, self.ff.hb_handle, potentials.HarmonicBond)

    def parameterize_harmonic_angle(self, ff_params):
        return self._parameterize_bonded_term(ff_params, self.ff.ha_handle, potentials.HarmonicAngle)

    def parameterize_proper_torsion(self, ff_params):
        return self._parameterize_bonded_term(ff_params, self.ff.pt_handle, potentials.PeriodicTorsion)

    def parameterize_improper_torsion(self, ff_params):
        return self._parameterize_bonded_term(ff_params, self.ff.it_handle, potentials.PeriodicTorsion)


class HostGuestTopology:
    """A host's potentials (a HostTerms' get_U_fns: bond, angle, proper,
    improper, nonbonded) combined with a guest topology's (ref
    topology.py:37-236). parameterize_nonbonded returns a SummedPotential of
    the host term over every atom with the guest masked out (atom_idxs),
    the guest x environment interaction group and the guest's
    intramolecular pair list."""

    def __init__(self, host_potentials, guest_topology, num_water_atoms: int, ff: Forcefield, host_topology: Any = None):
        self.guest_topology = guest_topology
        self.ff = ff
        self.host_topology = host_topology

        assert len(host_potentials) == 5
        self.host_harmonic_bond = host_potentials[0]
        self.host_harmonic_angle = host_potentials[1]
        self.host_proper_torsion = host_potentials[2]
        self.host_improper_torsion = host_potentials[3]
        self.host_nonbonded = host_potentials[4]
        assert isinstance(self.host_nonbonded.potential, potentials.Nonbonded)

        self.num_host_atoms = self.host_nonbonded.potential.num_atoms
        self.num_water_atoms = num_water_atoms
        self.num_other_atoms = self.num_host_atoms - num_water_atoms

        self.hg_nb_ixn_params = np.array(self.host_nonbonded.params.detach()).copy()
        if self.ff.env_bcc_handle is not None and host_topology is not None:
            env_bcc_h = self.ff.env_bcc_handle.get_env_handle(host_topology, self.ff)
            self.hg_nb_ixn_params[:, NBParamIdx.Q_IDX] = env_bcc_h.parameterize(self.ff.env_bcc_handle.params).detach().numpy()

    def get_water_idxs(self):
        return np.arange(self.num_water_atoms, dtype=np.int32) + self.num_other_atoms

    def get_other_idxs(self):
        return np.arange(self.num_other_atoms, dtype=np.int32)

    def get_env_idxs(self):
        return np.concatenate([self.get_other_idxs(), self.get_water_idxs()]).astype(np.int32)

    def get_num_atoms(self):
        return self.num_host_atoms + self.guest_topology.get_num_atoms()

    def get_component_idxs(self):
        host = [np.arange(self.num_host_atoms)] if self.num_host_atoms else []
        guest = [idx + self.num_host_atoms for idx in self.guest_topology.get_component_idxs()]
        return host + guest

    def get_lig_idxs(self):
        comps = self.get_component_idxs()
        comps = comps[1:] if self.num_host_atoms else comps
        return np.concatenate([np.asarray(c, dtype=np.int32) for c in comps])

    def _parameterize_bonded_term(self, guest_params, guest_potential, host_potential):
        if guest_potential is None:
            raise UnsupportedPotential("Mismatch in guest_potential")
        if host_potential is not None:
            assert isinstance(host_potential.potential, type(guest_potential))
        guest_idxs = guest_potential.idxs + self.num_host_atoms
        if host_potential is not None and host_potential.params.numel() > 0:
            host_params = host_potential.params
            host_idxs = host_potential.potential.idxs
        else:
            host_params = torch.zeros((0, guest_params.shape[1]), dtype=torch.float64)
            host_idxs = np.zeros((0, guest_idxs.shape[1]), dtype=guest_idxs.dtype)
        combined_params = torch.cat([as_f64(host_params), as_f64(guest_params)])
        combined_idxs = np.concatenate([host_idxs, guest_idxs])
        return combined_params, type(guest_potential)(combined_idxs)

    def parameterize_harmonic_bond(self, ff_params):
        params, pot = self.guest_topology.parameterize_harmonic_bond(ff_params)
        return self._parameterize_bonded_term(params, pot, self.host_harmonic_bond)

    def parameterize_harmonic_angle(self, ff_params):
        params, pot = self.guest_topology.parameterize_harmonic_angle(ff_params)
        return self._parameterize_bonded_term(params, pot, self.host_harmonic_angle)

    def parameterize_proper_torsion(self, ff_params):
        params, pot = self.guest_topology.parameterize_proper_torsion(ff_params)
        return self._parameterize_bonded_term(params, pot, self.host_proper_torsion)

    def parameterize_improper_torsion(self, ff_params):
        params, pot = self.guest_topology.parameterize_improper_torsion(ff_params)
        return self._parameterize_bonded_term(params, pot, self.host_improper_torsion)

    def parameterize_nonbonded(self, ff_q_params, ff_q_params_intra, ff_lj_params, ff_lj_params_intra, lamb: float):
        num_guest_atoms = self.guest_topology.get_num_atoms()
        guest_ixn_env_params, _ = self.guest_topology.parameterize_nonbonded(
            ff_q_params, None, ff_lj_params, None, lamb, intramol_params=False
        )
        guest_intra_params, guest_intra_pot = self.guest_topology.parameterize_nonbonded_pairlist(
            None, ff_q_params_intra, None, ff_lj_params_intra, intramol_params=True
        )
        beta = guest_intra_pot.beta
        cutoff = guest_intra_pot.cutoff
        guest_intra_pot = potentials.NonbondedPairListPrecomputed(guest_intra_pot.idxs + self.num_host_atoms, beta, cutoff)
        assert tuple(guest_ixn_env_params.shape) == (num_guest_atoms, 4)
        assert beta == self.host_nonbonded.potential.beta
        assert cutoff == self.host_nonbonded.potential.cutoff

        hg_nb_params = torch.cat([as_f64(self.host_nonbonded.params), torch.zeros(tuple(guest_ixn_env_params.shape), dtype=torch.float64)])
        host_guest_pot = potentials.Nonbonded(
            self.num_host_atoms + num_guest_atoms,
            self.host_nonbonded.potential.exclusion_idxs,
            self.host_nonbonded.potential.scale_factors,
            beta,
            cutoff,
            atom_idxs=np.arange(self.num_host_atoms, dtype=np.int32),
        )

        ixn_pot, ixn_params = get_ligand_ixn_pots_params(
            self.get_lig_idxs(), self.get_env_idxs(), self.hg_nb_ixn_params, guest_ixn_env_params, beta=beta, cutoff=cutoff
        )

        pots = [host_guest_pot, ixn_pot]
        params_list = [hg_nb_params, ixn_params]
        if guest_intra_params.shape[0] > 0:
            pots.append(guest_intra_pot)
            params_list.append(guest_intra_params)

        sum_pot = potentials.SummedPotential(pots, params_list)
        sum_params = torch.cat([p.reshape(-1) for p in params_list])
        return sum_params, sum_pot


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
