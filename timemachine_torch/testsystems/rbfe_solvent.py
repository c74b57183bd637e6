"""The solvent leg of the ethanol -> propane RBFE edge: 12 λ windows on a
fixed grid in a 4.1 nm TIP3P box (counterpart of the states that
timemachine_tpu/fe/rbfe.py estimate_relative_free_energy builds for a
solvent leg and hands to run_sims_sequential).

`load_rbfe_solvent` reads the states with numpy from
timemachine_torch/testsystems/cache/rbfe_solvent_ethanol_propane.npz, which
the JAX package writes (`python tests/test_torch_rbfe.py --write-cache`).
Arrays equal across the windows are stored once under "s_<key>", the others
per window under "w_<key>"; v0 is redrawn from its seed where the writer
checked that the draw is bitwise the JAX state's.

`build_rbfe_solvent` builds the same windows with the port's own state
builder from the inputs the cache records (SMILES, conformers, box, seed, λ
grid): molecules, AM1 charges, the force field, the atom mapping, the single
topology, the water box and every window's potentials, masses and seeds.
Only each window's minimized coordinates and box (x0, box0: the JAX
package's host pre-equilibration and minimization) are still taken from the
cache.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from timemachine_torch.chem import mol_from_smiles
from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS, ONE_4PI_EPS0
from timemachine_torch.device import resolve_device
from timemachine_torch.fe import rbfe
from timemachine_torch.fe.atom_mapping import get_cores
from timemachine_torch.fe.free_energy import InitialState
from timemachine_torch.fe.single_topology import SingleTopology
from timemachine_torch.fe.system import HostGuestSystem
from timemachine_torch.ff import Forcefield
from timemachine_torch.ff.handlers import compute_or_load_base_charges
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.builders import build_water_system
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


def build_rbfe_solvent(path=CACHE, device=None, dtype=torch.float64, windows=None, record=None) -> list:
    """The InitialStates of the windows (all by default), built by the port
    from the cache's recorded inputs, potentials on `device` (None: the
    card). Each window's x0 and box0 are the cache's: its minimized
    coordinates, which the port does not build yet.

    `record`, a dict, receives the core, the SingleTopology, the Host and each stage's
    host seconds under "seconds": parse, am1_<name> for each ligand, mapping,
    single_topology, water_box, and windows (one entry per window)."""
    a = load_arrays(path)
    meta = metadata(a)
    device = resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()
    mols = [mol_from_smiles(str(smi), add_hs=True, name=str(name)) for smi, name in zip(meta["smiles"], meta["names"])]
    for mol, conf in zip(mols, (meta["conf_a"], meta["conf_b"])):
        mol.set_conf(np.asarray(conf))
    ff = Forcefield.load_default()
    seconds["parse"] = time.perf_counter() - t0
    for mol in mols:
        t0 = time.perf_counter()
        compute_or_load_base_charges(mol, mode=ff.q_handle.base_mode)
        seconds[f"am1_{mol.name}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    core = get_cores(*mols, **DEFAULT_ATOM_MAPPING_KWARGS)[0]
    seconds["mapping"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = SingleTopology(mols[0], mols[1], core, ff)
    seconds["single_topology"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = build_water_system(float(meta["box_width"]), ff.water_ff, mols=mols)
    cfg.box += np.diag([float(meta["headroom"])] * 3)
    host = rbfe.Host(cfg.host_system, cfg.masses, cfg.conf, cfg.box, cfg.num_water_atoms, cfg.host_topology)
    seconds["water_box"] = time.perf_counter() - t0
    states = []
    seconds["windows"] = []
    temperature = float(a["temperature"])
    for w in range(n_windows(a)) if windows is None else windows:
        t0 = time.perf_counter()
        state = rbfe.setup_initial_state(st, float(a["lamb"][w]), host, temperature, int(meta["seed"]), device, dtype)
        win = window_arrays(a, w)
        state.x0, state.box0 = win["x0"], win["box0"]
        states.append(state)
        seconds["windows"].append(time.perf_counter() - t0)
    if record is not None:
        record.update(core=core, single_topology=st, host=host, seconds=seconds)
    return states


TERMS = ("bond", "angle", "proper", "improper", "chiral_atom", "nonbonded_pair_list", "nonbonded_all_pairs", "nonbonded_ixn_group")


def term_differences(built: InitialState, ref: InitialState) -> dict:
    """Per term of two states' potentials (in TERMS order): whether every
    index buffer is equal, each parameter column's largest absolute
    difference and that difference relative to the column's largest
    |value| (`max_rel` the largest of those), and whether the parameters
    are bitwise equal."""
    out = {}
    for name, pb, pr in zip(TERMS, built.potentials, ref.potentials, strict=True):
        bb, br = dict(pb.named_buffers()), dict(pr.named_buffers())
        assert type(pb) is type(pr) and bb.keys() == br.keys(), name
        idx = all(torch.equal(bb[k], br[k]) for k in bb if not bb[k].dtype.is_floating_point)
        others = all(torch.equal(bb[k], br[k]) for k in bb if bb[k].dtype.is_floating_point and k != "params")
        x, y = bb["params"], br["params"]
        same_shape = x.shape == y.shape
        abs_cols, rel_cols = [], []
        if same_shape and x.numel():
            x2, y2 = x.reshape(y.shape[0], -1), y.reshape(y.shape[0], -1)
            abs_diff = (x2 - y2).abs().amax(0)
            abs_cols = abs_diff.tolist()
            rel_cols = (abs_diff / y2.abs().amax(0).clamp_min(torch.finfo(y.dtype).tiny)).tolist()
        out[name] = dict(
            indices_equal=idx and others and same_shape, max_abs_by_column=abs_cols, max_rel_by_column=rel_cols,
            max_rel=max(rel_cols, default=0.0), bitwise=torch.equal(x, y),
        )
    return out


# the parameter columns that carry the ligands' AM1 charges: the interaction
# group's q sqrt(k) and the pair list's k q_i q_j
CHARGE_COLUMNS = (("nonbonded_ixn_group", 0), ("nonbonded_pair_list", 0))


def build_differences(states: list, refs: list) -> dict:
    """Built windows against reference ones (the cache's), over all windows:
    "indices_equal"; "other_rel", the largest difference of a parameter
    column without charges relative to the column's largest |value|; for the
    charge columns, that measure ("q_rel" for the interaction group's q,
    "qq_rel" for the pair list's q_i q_j) and the difference in e ("q_e",
    |d| / sqrt(k) over the ligand atoms; "qq_e", |d| / (2 k max|q|), the
    least charge difference that moves a product q_i q_j by d); "bitwise",
    the windows whose parameters are all bitwise the reference's, and
    "seeds", those whose integrator seed is the reference's."""
    out = dict(indices_equal=True, other_rel=0.0, q_rel=0.0, qq_rel=0.0, q_e=0.0, qq_e=0.0, bitwise=[], seeds=[])
    sqrt_k = ONE_4PI_EPS0**0.5
    for w, (s, r) in enumerate(zip(states, refs, strict=True)):
        diffs = term_differences(s, r)
        out["indices_equal"] &= all(d["indices_equal"] for d in diffs.values())
        ixn = r.potentials[TERMS.index("nonbonded_ixn_group")].params
        qmax_e = float(ixn[torch.as_tensor(r.ligand_idxs, device=ixn.device), 0].abs().max()) / sqrt_k
        for term, d in diffs.items():
            for col, (a, rel) in enumerate(zip(d["max_abs_by_column"], d["max_rel_by_column"])):
                if (term, col) == CHARGE_COLUMNS[0]:
                    out["q_rel"], out["q_e"] = max(out["q_rel"], rel), max(out["q_e"], a / sqrt_k)
                elif (term, col) == CHARGE_COLUMNS[1]:
                    out["qq_rel"], out["qq_e"] = max(out["qq_rel"], rel), max(out["qq_e"], a / (2.0 * ONE_4PI_EPS0 * qmax_e))
                else:
                    out["other_rel"] = max(out["other_rel"], rel)
        if all(d["bitwise"] for d in diffs.values()):
            out["bitwise"].append(w)
        if s.integrator.seed == r.integrator.seed:
            out["seeds"].append(w)
    return out
