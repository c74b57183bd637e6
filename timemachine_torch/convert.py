"""Carry a system across from the JAX package: a timemachine_tpu HostSystem
or HostConfig, or an RBFE window's InitialState or HostGuestSystem, becomes
the port's modules.

Reads the JAX objects by duck typing (`bp.potential.idxs`, `bp.params`,
`exclusion_idxs`, `scale_factors`, `beta`, `cutoff`, the potentials' class
names) through np.asarray, so this module imports neither jax nor the JAX
package; the port's own builders' terms (fe/terms.py) have the same shape
and go through the same functions. Every nonbonded configuration (`configure(kernel=...)`, "dot"
included) reads the same parameters, so nothing more is carried for any of
them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from timemachine_torch.fe.free_energy import InitialState
from timemachine_torch.fe.system import HostConfig, HostGuestSystem, HostSystem
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch import potentials as modules


def host_system_arrays(hs) -> dict:
    """Numpy arrays of a JAX HostSystem under the host npz keys."""
    a = {}
    for term in ("bond", "angle", "proper", "improper"):
        bp = getattr(hs, term)
        a[f"{term}_idxs"] = np.asarray(bp.potential.idxs)
        a[f"{term}_params"] = np.asarray(bp.params)
    nb = hs.nonbonded_all_pairs
    a["excl_idxs"] = np.asarray(nb.potential.exclusion_idxs)
    a["excl_scales"] = np.asarray(nb.potential.scale_factors)
    a["nb_params"] = np.asarray(nb.params)
    a["beta"] = float(nb.potential.beta)
    a["cutoff"] = float(nb.potential.cutoff)
    return a


def host_config_from_jax(cfg, device=None, dtype=torch.float64) -> HostConfig:
    """A JAX HostConfig as the port's HostConfig, potentials on `device`
    (None: the card)."""
    return HostConfig(
        host_system=HostSystem.from_arrays(host_system_arrays(cfg.host_system), device=device, dtype=dtype),
        conf=np.asarray(cfg.conf),
        box=np.asarray(cfg.box),
        num_water_atoms=int(cfg.num_water_atoms),
        group_idxs=[np.asarray(g) for g in cfg.host_topology.group_idxs],
        masses=np.asarray(cfg.masses),
    )


_HOST_GUEST_FIELDS = (
    "bond", "angle", "proper", "improper", "chiral_atom", "chiral_bond", "nonbonded_pair_list",
    "nonbonded_all_pairs", "nonbonded_ixn_group",
)
_VALENCE = {"HarmonicBond": "bond", "HarmonicAngle": "angle", "ChiralAtomRestraint": "chiral_atom"}


def host_guest_arrays(obj) -> dict:
    """Numpy arrays of an RBFE window under HostGuestSystem.from_arrays'
    keys, from a JAX HostGuestSystem, an InitialState (whose potentials leave
    out the inactive chiral bond term: it comes back empty) or a list of
    bound potentials in the system's order."""
    if hasattr(obj, "nonbonded_ixn_group"):
        bps = [getattr(obj, f) for f in _HOST_GUEST_FIELDS]
    else:
        bps = list(getattr(obj, "potentials", obj))
    a = {
        "chiral_bond_idxs": np.zeros((0, 4), np.int32),
        "chiral_bond_signs": np.zeros(0),
        "chiral_bond_params": np.zeros(0),
    }
    torsions = iter(("proper", "improper"))
    for bp in bps:
        pot, params, name = bp.potential, np.asarray(bp.params), type(bp.potential).__name__
        if name in _VALENCE or name == "PeriodicTorsion":
            key = _VALENCE.get(name) or next(torsions)
            a[f"{key}_idxs"], a[f"{key}_params"] = np.asarray(pot.idxs), params
        elif name == "ChiralBondRestraint":
            a["chiral_bond_idxs"], a["chiral_bond_signs"] = np.asarray(pot.idxs), np.asarray(pot.signs)
            a["chiral_bond_params"] = params
        elif name == "NonbondedPairListPrecomputed":
            a["pair_list_idxs"], a["pair_list_params"] = np.asarray(pot.idxs), params
            a["pair_list_beta"], a["pair_list_cutoff"] = float(pot.beta), float(pot.cutoff)
        elif name == "Nonbonded":
            a["excl_idxs"], a["excl_scales"] = np.asarray(pot.exclusion_idxs), np.asarray(pot.scale_factors)
            a["nb_params"], a["beta"], a["cutoff"] = params, float(pot.beta), float(pot.cutoff)
            a["atom_idxs"] = np.arange(int(pot.num_atoms)) if pot.atom_idxs is None else np.asarray(pot.atom_idxs)
        elif name == "NonbondedInteractionGroup":
            rows = np.asarray(pot.row_atom_idxs)
            cols = pot.col_atom_idxs
            a["ixn_row_idxs"] = rows
            a["ixn_col_idxs"] = np.setdiff1d(np.arange(int(pot.num_atoms)), rows) if cols is None else np.asarray(cols)
            a["ixn_params"], a["ixn_beta"], a["ixn_cutoff"] = params, float(pot.beta), float(pot.cutoff)
        else:
            raise ValueError(f"host_guest_arrays: no port of {name}")
    return a


class _Bound(NamedTuple):
    """A member of a fan-out sum bound to the sum's shared parameters."""

    potential: object
    params: object


def modules_from_bound_potentials(bps, num_atoms: int, device=None, dtype=torch.float64) -> list:
    """Bound potentials (the port's builders' terms, or the JAX package's),
    each as the port's module over num_atoms atoms on `device` (None: the
    card), in the order given: the AHFE windows' flat list (bond, angle,
    proper, improper, the host term, the interaction group, the pair list),
    which no system class orders. A FanoutSummedPotential becomes the
    port's, its members each converted at the shared parameters."""
    out = []
    for bp in bps:
        pot, params, name = bp.potential, np.asarray(bp.params), type(bp.potential).__name__
        kw = dict(device=device, dtype=dtype)
        if name in ("HarmonicBond", "HarmonicAngle", "PeriodicTorsion", "ChiralAtomRestraint"):
            out.append(getattr(modules, name)(np.asarray(pot.idxs), params, num_atoms, **kw))
        elif name == "NonbondedPairListPrecomputed":
            out.append(modules.NonbondedPairListPrecomputed(np.asarray(pot.idxs), params, pot.beta, pot.cutoff, num_atoms, **kw))
        elif name == "Nonbonded":
            atom_idxs = None if pot.atom_idxs is None else np.asarray(pot.atom_idxs)
            out.append(modules.Nonbonded(int(pot.num_atoms), np.asarray(pot.exclusion_idxs), np.asarray(pot.scale_factors),
                                         pot.beta, pot.cutoff, params, atom_idxs=atom_idxs, **kw))
        elif name == "NonbondedInteractionGroup":
            cols = None if pot.col_atom_idxs is None else np.asarray(pot.col_atom_idxs)
            out.append(modules.NonbondedInteractionGroup(int(pot.num_atoms), np.asarray(pot.row_atom_idxs), pot.beta,
                                                         pot.cutoff, params, col_atom_idxs=cols, **kw))
        elif name == "CentroidRestraint":
            out.append(modules.CentroidRestraint(np.asarray(pot.group_a_idxs), np.asarray(pot.group_b_idxs), pot.kb,
                                                 pot.b0, params, num_atoms, **kw))
        elif name == "FanoutSummedPotential":
            members = modules_from_bound_potentials([_Bound(p, params) for p in pot.potentials], num_atoms, **kw)
            out.append(modules.FanoutSummedPotential(members, params, **kw))
        else:
            raise ValueError(f"modules_from_bound_potentials: no port of {name}")
    return out


def initial_state_from_jax(state, device=None, dtype=torch.float64) -> InitialState:
    """A JAX InitialState of an RBFE window as the port's, potentials on
    `device` (None: the card)."""
    intg, baro = state.integrator, state.barostat
    masses = np.asarray(intg.masses)
    barostat = None
    if baro is not None:
        barostat = MonteCarloBarostat(
            int(baro.num_atoms), float(baro.pressure), float(baro.temperature),
            [np.asarray(g) for g in baro.group_idxs], int(baro.interval), int(baro.seed),
            bool(baro.adaptive_scaling_enabled), float(baro.initial_volume_scale_factor),
        )
    system = HostGuestSystem.from_arrays(host_guest_arrays(state), device=device, dtype=dtype)
    return InitialState(
        potentials=system.get_U_fns(),
        integrator=LangevinIntegrator(float(intg.temperature), float(intg.dt), float(intg.friction), masses, int(intg.seed)),
        barostat=barostat,
        x0=np.asarray(state.x0),
        v0=np.asarray(state.v0),
        box0=np.asarray(state.box0),
        lamb=float(state.lamb),
        ligand_idxs=np.asarray(state.ligand_idxs),
        protein_idxs=np.asarray(state.protein_idxs),
        interacting_atoms=None if state.interacting_atoms is None else np.asarray(state.interacting_atoms),
    )
