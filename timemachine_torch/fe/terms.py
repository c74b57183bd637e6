"""The state builders' potentials, before they become modules on a device.

timemachine_tpu builds a window's potentials as `Potential(idxs...).bind(params)`
(timemachine_tpu/potentials.py) and gathers them in the systems of
timemachine_tpu/fe/system.py. The port's builders (fe/topology.py,
fe/single_topology.py, md/builders.py, fe/rbfe.py) do the same with the
classes here, which keep the JAX names and fields: a potential holds its
numpy index arrays and scalars, and `bind` pairs it with a torch f64
parameter tensor on the CPU (carrying autograd where a handler's parameters
do, as jnp does under jax.grad). `HostTerms`, `GuestTerms` and
`HostGuestTerms` are the three systems; a window's `to_system(device)` gives
the port's modules (fe/system.py) on the device, through
convert.host_guest_arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from timemachine_torch.convert import host_guest_arrays
from timemachine_torch.fe.system import GuestSystem, HostGuestSystem
from timemachine_torch.ff.handlers import as_f64


@dataclass(eq=False)
class BoundPotential:
    potential: object
    params: torch.Tensor


class _Potential:
    def bind(self, params) -> BoundPotential:
        return BoundPotential(self, as_f64(params))


@dataclass(eq=False)
class HarmonicBond(_Potential):
    idxs: np.ndarray


@dataclass(eq=False)
class HarmonicAngle(_Potential):
    idxs: np.ndarray


@dataclass(eq=False)
class PeriodicTorsion(_Potential):
    idxs: np.ndarray


@dataclass(eq=False)
class ChiralAtomRestraint(_Potential):
    idxs: np.ndarray


@dataclass(eq=False)
class ChiralBondRestraint(_Potential):
    idxs: np.ndarray
    signs: np.ndarray


@dataclass(eq=False)
class NonbondedPairListPrecomputed(_Potential):
    idxs: np.ndarray
    beta: float
    cutoff: float


@dataclass(eq=False)
class Nonbonded(_Potential):
    num_atoms: int
    exclusion_idxs: np.ndarray
    scale_factors: np.ndarray
    beta: float
    cutoff: float
    atom_idxs: Optional[np.ndarray] = None


@dataclass(eq=False)
class NonbondedInteractionGroup(_Potential):
    num_atoms: int
    row_atom_idxs: np.ndarray
    beta: float
    cutoff: float
    col_atom_idxs: Optional[np.ndarray] = None


_INACTIVE_TERMS = frozenset({"chiral_bond"})


class _Terms:
    def get_U_fns(self) -> list:
        """The bound potentials in field order, without the inactive chiral
        bond term (as timemachine_tpu/fe/system.py's get_U_fns)."""
        return [getattr(self, f.name) for f in fields(self) if f.name not in _INACTIVE_TERMS]


@dataclass(eq=False)
class HostTerms(_Terms):
    bond: BoundPotential
    angle: BoundPotential
    proper: BoundPotential
    improper: BoundPotential
    nonbonded_all_pairs: BoundPotential


@dataclass(eq=False)
class GuestTerms(_Terms):
    bond: BoundPotential
    angle: BoundPotential
    proper: BoundPotential
    improper: BoundPotential
    chiral_atom: BoundPotential
    chiral_bond: BoundPotential
    nonbonded_pair_list: BoundPotential

    def to_system(self, num_atoms: int, device=None, dtype=torch.float64):
        """The port's GuestSystem over `num_atoms` atoms on `device` (None: the card)."""
        a = host_guest_arrays([getattr(self, f.name) for f in fields(self)])
        return GuestSystem.from_arrays(a, num_atoms, device=device, dtype=dtype)


@dataclass(eq=False)
class HostGuestTerms(_Terms):
    bond: BoundPotential
    angle: BoundPotential
    proper: BoundPotential
    improper: BoundPotential
    chiral_atom: BoundPotential
    chiral_bond: BoundPotential
    nonbonded_pair_list: BoundPotential
    nonbonded_all_pairs: BoundPotential
    nonbonded_ixn_group: BoundPotential

    def arrays(self) -> dict:
        """Numpy arrays under HostGuestSystem.from_arrays' keys."""
        return host_guest_arrays(self)

    def to_system(self, device=None, dtype=torch.float64):
        """The port's HostGuestSystem on `device` (None: the card)."""
        return HostGuestSystem.from_arrays(self.arrays(), device=device, dtype=dtype)
