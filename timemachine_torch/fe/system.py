"""Host system and host configuration
(counterpart of timemachine_tpu/fe/system.py HostSystem and the HostConfig
of timemachine_tpu/md/builders.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from timemachine_torch.potentials import HarmonicAngle, HarmonicBond, Nonbonded, PeriodicTorsion


@dataclass
class HostSystem:
    bond: HarmonicBond
    angle: HarmonicAngle
    proper: PeriodicTorsion
    improper: PeriodicTorsion
    nonbonded_all_pairs: Nonbonded

    def get_U_fns(self) -> list:
        """The potentials in the JAX package's order: bond, angle, proper,
        improper, nonbonded."""
        return [self.bond, self.angle, self.proper, self.improper, self.nonbonded_all_pairs]

    @classmethod
    def from_arrays(cls, a: dict, device=None, dtype=torch.float64) -> "HostSystem":
        """From numpy arrays under the keys of the JAX package's host npz
        (bond_idxs, bond_params, ..., excl_idxs, excl_scales, nb_params,
        beta, cutoff)."""
        n = a["nb_params"].shape[0]
        kw = dict(device=device, dtype=dtype)
        return cls(
            bond=HarmonicBond(a["bond_idxs"], a["bond_params"], n, **kw),
            angle=HarmonicAngle(a["angle_idxs"], a["angle_params"], n, **kw),
            proper=PeriodicTorsion(a["proper_idxs"], a["proper_params"], n, **kw),
            improper=PeriodicTorsion(a["improper_idxs"], a["improper_params"], n, **kw),
            nonbonded_all_pairs=Nonbonded(
                n, a["excl_idxs"], a["excl_scales"], float(a["beta"]), float(a["cutoff"]), a["nb_params"], **kw
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
