"""Solvated DHFR (23,558 atoms), the apo-MD benchmark system
(counterpart of timemachine_tpu/testsystems/dhfr.py setup_dhfr_native and
of load_host_config / permute_host_config_atoms in md/builders.py).

Reads the parameterized arrays that ship with the JAX package
(timemachine_tpu/testsystems/cache/dhfr_native.npz) with numpy alone.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from timemachine_torch.fe.system import HostConfig, HostSystem
from timemachine_torch.md.utils import get_group_indices

DHFR_NPZ = Path(__file__).resolve().parents[2] / "timemachine_tpu" / "testsystems" / "cache" / "dhfr_native.npz"

_TERMS = ("bond", "angle", "proper", "improper")


def load_host_arrays(path=DHFR_NPZ) -> dict:
    """All arrays of a host npz as numpy (term idxs/params, excl_idxs,
    excl_scales, nb_params, beta, cutoff, conf, box, masses,
    num_water_atoms)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def permute_host_arrays(a: dict, perm: np.ndarray) -> dict:
    """Renumber atoms by perm (new atom i is old atom perm[i]); term rows
    whose atoms all lie in the first num_water_atoms new atoms lead, so the
    leading-water paths still find the waters."""
    perm = np.asarray(perm, dtype=np.int64)
    n = a["conf"].shape[0]
    if perm.shape != (n,):
        raise ValueError(f"perm must have shape ({n},)")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    n_w = int(a["num_water_atoms"])

    def remap_rows(idxs, params):
        idxs = inv[np.asarray(idxs, dtype=np.int64)]
        is_water = np.all(idxs < n_w, axis=1)
        order = np.concatenate([np.nonzero(is_water)[0], np.nonzero(~is_water)[0]])
        return idxs[order].astype(np.int32), np.asarray(params)[order]

    out = dict(a)
    for term in _TERMS:
        out[f"{term}_idxs"], out[f"{term}_params"] = remap_rows(a[f"{term}_idxs"], a[f"{term}_params"])
    out["excl_idxs"], out["excl_scales"] = remap_rows(a["excl_idxs"], a["excl_scales"])
    for k in ("nb_params", "conf", "masses"):
        out[k] = np.asarray(a[k])[perm]
    return out


def setup_dhfr(waters_first: bool = True, device=None, dtype=torch.float64, path=DHFR_NPZ) -> HostConfig:
    """The DHFR HostConfig. waters_first=True puts the 7,023 waters ahead of
    the protein, the apo-benchmark order. Molecule groups come from the bond
    graph of the file's own atom order, renumbered like the atoms."""
    a = load_host_arrays(path)
    n = a["conf"].shape[0]
    groups = get_group_indices([tuple(map(int, b)) for b in a["bond_idxs"]], n)
    if waters_first:
        n_p = n - int(a["num_water_atoms"])
        perm = np.concatenate([np.arange(n_p, n), np.arange(n_p)])
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        a = permute_host_arrays(a, perm)
        groups = [np.sort(inv[g]) for g in groups]
    return HostConfig(
        host_system=HostSystem.from_arrays(a, device=device, dtype=dtype),
        conf=a["conf"],
        box=a["box"],
        num_water_atoms=int(a["num_water_atoms"]),
        group_idxs=groups,
        masses=a["masses"],
    )
