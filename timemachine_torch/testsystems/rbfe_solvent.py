"""The solvent leg of the ethanol -> propane RBFE edge: 12 λ windows on a
fixed grid in a 4.1 nm TIP3P box (counterpart of the states that
timemachine_tpu/fe/rbfe.py estimate_relative_free_energy builds for a
solvent leg and hands to run_sims_sequential).

The states are read with numpy from
timemachine_torch/testsystems/cache/rbfe_solvent_ethanol_propane.npz, which
the JAX package writes (`python tests/test_torch_rbfe.py --write-cache`):
the port cannot build them, since the alchemical system builder is not
ported. Arrays equal across the windows are stored once under "s_<key>",
the others per window under "w_<key>"; v0 is redrawn from its seed where
the writer checked that the draw is bitwise the JAX state's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from timemachine_torch.device import resolve_device
from timemachine_torch.fe.free_energy import InitialState
from timemachine_torch.fe.system import HostGuestSystem
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.utils import sample_velocities

CACHE = Path(__file__).resolve().parent / "cache" / "rbfe_solvent_ethanol_propane.npz"


def load_arrays(path=CACHE) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def n_windows(a: dict) -> int:
    return int(a["lamb"].shape[0])


def window_arrays(a: dict, w: int) -> dict:
    """Every array of window w under its plain key (s_ and w_ prefixes resolved)."""
    out = {k[2:]: v for k, v in a.items() if k.startswith("s_")}
    out.update({k[2:]: v[w] for k, v in a.items() if k.startswith("w_")})
    return out


def metadata(a: dict) -> dict:
    """What the writer recorded of its inputs: SMILES, names, seeds, box,
    headroom, λ grid, minimization cutoff, the atom mapping's core and the
    seconds the JAX package took to build the states."""
    return {k[5:]: a[k] for k in a if k.startswith("meta_")}


def _groups(a: dict) -> list:
    return np.split(a["group_atoms"], np.cumsum(a["group_sizes"])[:-1])


def initial_state(a: dict, w: int, device=None, dtype=torch.float64) -> InitialState:
    """Window w's InitialState, potentials on `device` (None: the card)."""
    device = resolve_device(device)
    win = window_arrays(a, w)
    masses = a["masses"]
    temperature = float(a["temperature"])
    v0_seed = int(a["v0_seed"][w])
    v0 = sample_velocities(masses, temperature, v0_seed) if v0_seed >= 0 else win["v0"]
    interacting = np.split(a["interacting_atoms"], np.cumsum(a["interacting_counts"])[:-1])[w]
    return InitialState(
        potentials=HostGuestSystem.from_arrays(win, device=device, dtype=dtype).get_U_fns(),
        integrator=LangevinIntegrator(temperature, float(a["dt"]), float(a["friction"]), masses, int(a["integrator_seed"][w])),
        barostat=MonteCarloBarostat(
            masses.shape[0], float(a["pressure"]), temperature, _groups(a), int(a["barostat_interval"]),
            int(a["barostat_seed"][w]), bool(a["adaptive_scaling_enabled"]), float(a["initial_volume_scale_factor"]),
        ),
        x0=win["x0"],
        v0=v0,
        box0=win["box0"],
        lamb=float(a["lamb"][w]),
        ligand_idxs=a["ligand_idxs"],
        protein_idxs=a["protein_idxs"],
        interacting_atoms=interacting,
    )


def load_rbfe_solvent(path=CACHE, device=None, dtype=torch.float64, windows=None) -> list:
    """The InitialStates of the windows (all by default), potentials on
    `device` (None: the card)."""
    a = load_arrays(path)
    device = resolve_device(device)
    return [initial_state(a, w, device, dtype) for w in (range(n_windows(a)) if windows is None else windows)]
