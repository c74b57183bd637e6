"""Systems and the host configuration (counterpart of
timemachine_tpu/fe/system.py HostSystem, GuestSystem and HostGuestSystem,
and of the HostConfig of timemachine_tpu/md/builders.py).

A system is an ordered bag of potentials, one per field; `get_U_fns` lists
them in field order, leaving out the chiral bond restraints, which the JAX
package ships disabled.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from timemachine_torch.device import resolve_device
from timemachine_torch.potentials import (
    ChiralAtomRestraint,
    ChiralBondRestraint,
    HarmonicAngle,
    HarmonicBond,
    Nonbonded,
    NonbondedInteractionGroup,
    NonbondedPairListPrecomputed,
    PeriodicTorsion,
)

_INACTIVE_TERMS = frozenset({"chiral_bond"})


class _System:
    def get_U_fns(self) -> list:
        """The potentials in field order, without the inactive chiral bond term."""
        return [getattr(self, f.name) for f in fields(self) if f.name not in _INACTIVE_TERMS]


def _valence_terms(a: dict, n: int, kw: dict) -> dict:
    return dict(
        bond=HarmonicBond(a["bond_idxs"], a["bond_params"], n, **kw),
        angle=HarmonicAngle(a["angle_idxs"], a["angle_params"], n, **kw),
        proper=PeriodicTorsion(a["proper_idxs"], a["proper_params"], n, **kw),
        improper=PeriodicTorsion(a["improper_idxs"], a["improper_params"], n, **kw),
    )


def _guest_terms(a: dict, n: int, kw: dict) -> dict:
    return dict(
        chiral_atom=ChiralAtomRestraint(a["chiral_atom_idxs"], a["chiral_atom_params"], n, **kw),
        chiral_bond=ChiralBondRestraint(a["chiral_bond_idxs"], a["chiral_bond_signs"], a["chiral_bond_params"], n, **kw),
        nonbonded_pair_list=NonbondedPairListPrecomputed(
            a["pair_list_idxs"], a["pair_list_params"], float(a["pair_list_beta"]), float(a["pair_list_cutoff"]), n,
            **kw,
        ),
    )


@dataclass
class HostSystem(_System):
    bond: HarmonicBond
    angle: HarmonicAngle
    proper: PeriodicTorsion
    improper: PeriodicTorsion
    nonbonded_all_pairs: Nonbonded

    @classmethod
    def from_arrays(cls, a: dict, device=None, dtype=torch.float64) -> "HostSystem":
        """From numpy arrays under the keys of the JAX package's host npz
        (bond_idxs, bond_params, ..., excl_idxs, excl_scales, nb_params,
        beta, cutoff), on `device` (None: the card)."""
        n = a["nb_params"].shape[0]
        kw = dict(device=resolve_device(device), dtype=dtype)
        return cls(
            **_valence_terms(a, n, kw),
            nonbonded_all_pairs=Nonbonded(
                n, a["excl_idxs"], a["excl_scales"], float(a["beta"]), float(a["cutoff"]), a["nb_params"], **kw
            ),
        )


@dataclass
class GuestSystem(_System):
    """A ligand alone (the vacuum leg's system)."""

    bond: HarmonicBond
    angle: HarmonicAngle
    proper: PeriodicTorsion
    improper: PeriodicTorsion
    chiral_atom: ChiralAtomRestraint
    chiral_bond: ChiralBondRestraint
    nonbonded_pair_list: NonbondedPairListPrecomputed

    @classmethod
    def from_arrays(cls, a: dict, num_atoms: int, device=None, dtype=torch.float64) -> "GuestSystem":
        """From numpy arrays under the keys of HostGuestSystem.from_arrays'
        valence, chiral and pair-list terms, on `device` (None: the card)."""
        kw = dict(device=resolve_device(device), dtype=dtype)
        return cls(**_valence_terms(a, num_atoms, kw), **_guest_terms(a, num_atoms, kw))


@dataclass
class HostGuestSystem(_System):
    """One alchemical window of a ligand in its host: the combined valence
    terms, the ligand's chiral restraints and intramolecular pairs, the
    host-only all-pairs term (an atom subset) and the ligand x environment
    interaction group. `get_U_fns` gives the JAX package's order: bond,
    angle, proper, improper, chiral_atom, nonbonded_pair_list,
    nonbonded_all_pairs, nonbonded_ixn_group."""

    bond: HarmonicBond
    angle: HarmonicAngle
    proper: PeriodicTorsion
    improper: PeriodicTorsion
    chiral_atom: ChiralAtomRestraint
    chiral_bond: ChiralBondRestraint
    nonbonded_pair_list: NonbondedPairListPrecomputed
    nonbonded_all_pairs: Nonbonded
    nonbonded_ixn_group: NonbondedInteractionGroup

    @classmethod
    def from_arrays(cls, a: dict, device=None, dtype=torch.float64) -> "HostGuestSystem":
        """From numpy arrays: the valence terms under HostSystem's keys;
        chiral_atom_idxs/params, chiral_bond_idxs/signs/params;
        pair_list_idxs/params/beta/cutoff (precomputed pair rows);
        excl_idxs, excl_scales, nb_params, atom_idxs, beta, cutoff of the
        host term; ixn_row_idxs, ixn_col_idxs, ixn_params, ixn_beta,
        ixn_cutoff of the interaction group. On `device` (None: the card)."""
        n = a["nb_params"].shape[0]
        kw = dict(device=resolve_device(device), dtype=dtype)
        return cls(
            **_valence_terms(a, n, kw),
            **_guest_terms(a, n, kw),
            nonbonded_all_pairs=Nonbonded(
                n, a["excl_idxs"], a["excl_scales"], float(a["beta"]), float(a["cutoff"]), a["nb_params"],
                atom_idxs=a["atom_idxs"], **kw,
            ),
            nonbonded_ixn_group=NonbondedInteractionGroup(
                n, a["ixn_row_idxs"], float(a["ixn_beta"]), float(a["ixn_cutoff"]), a["ixn_params"],
                col_atom_idxs=a["ixn_col_idxs"], **kw,
            ),
        )


@dataclass
class HostConfig:
    host_system: HostSystem
    conf: np.ndarray  # (N, 3) nm
    box: np.ndarray  # (3, 3) nm
    num_water_atoms: int
    group_idxs: list  # molecules as sorted atom-index arrays (the barostat's rigid groups)
    masses: np.ndarray  # (N,) amu
