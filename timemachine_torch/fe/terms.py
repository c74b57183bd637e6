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

from timemachine_torch.ff.handlers import as_f64


@dataclass(eq=False)
class BoundPotential:
    potential: object
    params: torch.Tensor

    def __call__(self, conf, box):
        """The energy at (conf, box), by the port's module of this potential
        on conf's device and in its dtype."""
        if isinstance(self.potential, SummedPotential):
            return self.potential(conf, self.params, box)
        from timemachine_torch.convert import modules_from_bound_potentials

        module = modules_from_bound_potentials([self], conf.shape[0], device=conf.device, dtype=conf.dtype)[0]
        return module.energy(conf, box)


class Potential:
    """Base class of the builders' potentials (JAX's potentials.Potential)."""

    def bind(self, params) -> BoundPotential:
        return BoundPotential(self, as_f64(params))


@dataclass(eq=False)
class HarmonicBond(Potential):
    idxs: np.ndarray


@dataclass(eq=False)
class HarmonicAngle(Potential):
    idxs: np.ndarray


@dataclass(eq=False)
class PeriodicTorsion(Potential):
    idxs: np.ndarray


@dataclass(eq=False)
class ChiralAtomRestraint(Potential):
    idxs: np.ndarray


@dataclass(eq=False)
class ChiralBondRestraint(Potential):
    idxs: np.ndarray
    signs: np.ndarray


@dataclass(eq=False)
class NonbondedPairListPrecomputed(Potential):
    idxs: np.ndarray
    beta: float
    cutoff: float


@dataclass(eq=False)
class Nonbonded(Potential):
    num_atoms: int
    exclusion_idxs: np.ndarray
    scale_factors: np.ndarray
    beta: float
    cutoff: float
    atom_idxs: Optional[np.ndarray] = None


@dataclass(eq=False)
class NonbondedInteractionGroup(Potential):
    num_atoms: int
    row_atom_idxs: np.ndarray
    beta: float
    cutoff: float
    col_atom_idxs: Optional[np.ndarray] = None


@dataclass(eq=False)
class SummedPotential(Potential):
    """Several potentials over one flat parameter vector, the concatenation
    of each one's raveled parameters (HostGuestTopology's nonbonded term)."""

    potentials: list
    params_init: list

    def __post_init__(self):
        if len(self.potentials) != len(self.params_init):
            raise ValueError("number of potentials != number of parameter arrays")
        self.params_shapes = [tuple(np.shape(p)) for p in self.params_init]

    def unflatten_params(self, params) -> list:
        """The flat vector split back into each potential's parameters."""
        sizes = [int(np.prod(s)) for s in self.params_shapes]
        return [p.reshape(s) for p, s in zip(torch.split(as_f64(params), sizes), self.params_shapes)]

    def bound_potentials(self, params) -> list:
        """Each potential bound to its share of the flat vector."""
        return [pot.bind(p) for pot, p in zip(self.potentials, self.unflatten_params(params))]

    def __call__(self, x, params, box):
        """The float64 sum of each potential's u(x, p, box) at its share p of
        the flat vector, where the potentials are the port's modules (as
        make_summed_potential makes them): each evaluated in its own dtype
        on its device."""
        us = []
        for pot, p in zip(self.potentials, self.unflatten_params(params)):
            dev, dt = pot.params.device, pot.params.dtype
            xt, boxt = (torch.as_tensor(a, device=dev, dtype=dt) for a in (x, box))
            us.append(pot.u(xt, p.to(device=dev, dtype=dt), boxt).to(torch.float64))
        return torch.stack(us).sum()


def make_summed_potential(potentials) -> BoundPotential:
    """The potentials (the port's modules) as one SummedPotential bound to the
    concatenation of their raveled parameters (JAX's make_summed_potential)."""
    params = [pot.params.detach() for pot in potentials]
    flat = torch.cat([as_f64(p).reshape(-1) for p in params])
    return SummedPotential(list(potentials), params).bind(flat)


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
        from timemachine_torch.convert import host_guest_arrays
        from timemachine_torch.fe.system import GuestSystem

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
        from timemachine_torch.convert import host_guest_arrays

        return host_guest_arrays(self)

    def to_system(self, device=None, dtype=torch.float64):
        """The port's HostGuestSystem on `device` (None: the card)."""
        from timemachine_torch.fe.system import HostGuestSystem

        return HostGuestSystem.from_arrays(self.arrays(), device=device, dtype=dtype)
