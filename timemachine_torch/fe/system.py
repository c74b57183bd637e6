"""Systems and the host configuration (counterpart of
timemachine_tpu/fe/system.py HostSystem, GuestSystem and HostGuestSystem,
and of the HostConfig of timemachine_tpu/md/builders.py).

A system is an ordered bag of potentials, one per field; `get_U_fns` lists
them in field order, leaving out the chiral bond restraints, which the JAX
package ships disabled. `minimize_scipy` and `simulate_system` minimize and
sample a torch energy function of the coordinates, for estimator tests.
"""

from __future__ import annotations

from abc import ABC
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

def minimize_scipy(U_fn, x0, return_traj=False, seed=2024, method="BFGS", device=None):
    """scipy minimization of a torch energy function U_fn(x) over flattened
    coordinates, its gradient by autograd in float64 on `device` (None: the
    card); numpy out. method="basinhopping" runs scipy's stochastic global
    search from `seed`."""
    import scipy.optimize

    device = resolve_device(device)
    shape = tuple(np.shape(x0))
    unflatten = lambda flat: flat.reshape(*shape)

    def fun(flat):
        x = torch.tensor(flat, dtype=torch.float64, device=device).reshape(shape).requires_grad_(True)
        u = U_fn(x)
        (g,) = torch.autograd.grad(u, x)
        return float(u.detach()), g.detach().cpu().numpy().reshape(-1)

    traj = []
    kwargs = dict(jac=True, callback=lambda flat: traj.append(unflatten(flat)))
    flat0 = np.asarray(x0, dtype=np.float64).reshape(-1)
    if method == "basinhopping":
        res = scipy.optimize.basinhopping(fun, flat0, minimizer_kwargs=kwargs, seed=seed)
    else:
        res = scipy.optimize.minimize(fun, flat0, method=method, **kwargs)
    return traj if return_traj else unflatten(res.x)


def _walker_noise(generator: torch.Generator, shape, dtype):
    """One step's normals for every walker, (W, N, 3)."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)


def simulate_system(U_fn, x0, num_samples=20000, steps_per_batch=500, num_workers=None, minimize=True, temperature=300.0,
                    device=None):
    """Vacuum Langevin samples of U_fn(x) for estimator tests: num_workers
    walkers (default 8) stepped together on `device` (None: the card), their
    forces by autograd of the walkers' summed energy, their noise drawn from
    one torch.Generator where JAX splits keys (ROADMAP P38). Each walker
    keeps one frame a batch of steps_per_batch steps after a tenth of its
    batches of burn-in; (num_samples, N, 3) numpy, walker-major."""
    from timemachine_torch.integrators import langevin_coefficients

    device = resolve_device(device)
    num_atoms = x0.shape[0]
    seed = 2023
    x_min = minimize_scipy(U_fn, x0, seed=seed, device=device) if minimize else np.asarray(x0)

    num_workers = num_workers or 8
    samples_per_worker = int(np.ceil(num_samples / num_workers))
    burn_in = samples_per_worker // 10 + 1

    dt = 1.5e-3
    masses = np.ones(num_atoms) * 4.0
    ca, cb, cc = langevin_coefficients(temperature, dt, 1.0, masses)
    cb = torch.tensor(cb[:, None], dtype=torch.float64, device=device)
    cc = torch.tensor(cc[:, None], dtype=torch.float64, device=device)
    generator = torch.Generator(device).manual_seed(seed)

    x = torch.tensor(np.asarray(x_min, dtype=np.float64), device=device).expand(num_workers, num_atoms, 3).clone()
    v = torch.zeros_like(x)
    frames = []
    for batch in range(samples_per_worker + burn_in):
        for _ in range(steps_per_batch):
            xg = x.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(torch.func.vmap(U_fn)(xg).sum(), xg)
            noise = _walker_noise(generator, x.shape, x.dtype)
            v_mid = v - cb * grad
            v2 = ca * v_mid + cc * noise
            x = x + 0.5 * dt * (v_mid + v2)
            v = v2
        if batch >= burn_in:
            frames.append(x.detach())
    frames = torch.stack(frames, dim=1).cpu().numpy().reshape(-1, num_atoms, 3)[:num_samples]
    assert len(frames) == num_samples
    return frames


_INACTIVE_TERMS = frozenset({"chiral_bond"})


@dataclass
class AbstractSystem(ABC):
    """A system is an ordered bag of potentials, one per dataclass field;
    subclasses differ only in which term families they carry."""

    def get_U_fns(self) -> list:
        """The potentials in field order, without the inactive chiral bond term."""
        return [getattr(self, f.name) for f in fields(self) if f.name not in _INACTIVE_TERMS]

    def get_U_fn(self):
        """x -> the vacuum energy summed over get_U_fns()."""
        bound = self.get_U_fns()
        return lambda x: sum(m.energy(x, None) for m in bound)


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
class HostSystem(AbstractSystem):
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
class GuestSystem(AbstractSystem):
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
class HostGuestSystem(AbstractSystem):
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
