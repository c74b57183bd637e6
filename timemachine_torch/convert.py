"""Carry a system across from the JAX package: a timemachine_tpu HostSystem
or HostConfig becomes the port's modules.

Reads the JAX objects by duck typing (`bp.potential.idxs`, `bp.params`,
`exclusion_idxs`, `scale_factors`, `beta`, `cutoff`) through np.asarray,
so this module imports neither jax nor the JAX package. Every nonbonded
configuration (`configure(kernel=...)`, "dot" included) reads the same
parameters, so nothing more is carried for any of them.
"""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch.fe.system import HostConfig, HostSystem


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
