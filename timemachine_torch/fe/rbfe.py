"""RBFE window states: one λ window's InitialState of a single-topology
edge, in vacuum or in a host (the port of Host, setup_in_vacuum,
setup_in_env, _interacting_ligand_atoms, setup_initial_state and
assert_all_states_have_same_masses of timemachine_tpu/fe/rbfe.py).

The window's potentials are built as fe/terms.py terms on the host and put
on the device at the end. Seeds are derived as the JAX package derives them,
from this package's own bytes: the velocities' and the barostat's from the
ligand conformer, the integrator's from every potential's f64 parameters.
optimize_coordinates, setup_initial_states, AlchemicalEdge, the bisection
estimators and the leg drivers are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from timemachine_torch.constants import BAROSTAT_INTERVAL, DEFAULT_PRESSURE, MAX_SEED_VALUE, MD_DT, MD_FRICTION
from timemachine_torch.device import resolve_device
from timemachine_torch.fe import model_utils
from timemachine_torch.fe.free_energy import InitialState
from timemachine_torch.fe.single_topology import AtomMapFlags, SingleTopology
from timemachine_torch.fe.terms import HostTerms
from timemachine_torch.fe.utils import bytes_to_id, get_romol_conf
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.utils import get_bond_list, get_group_indices, sample_velocities


@dataclass
class Host:
    system: HostTerms
    physical_masses: list
    conf: np.ndarray
    box: np.ndarray
    num_water_atoms: int
    host_topology: object


def setup_in_vacuum(st: SingleTopology, ligand_conf, lamb):
    """Vacuum leg environment: ligand-only terms in a big fixed box."""
    system = st.setup_intermediate_state(lamb)
    return (
        ligand_conf,
        np.eye(3, dtype=np.float64) * 10.0,
        np.array(st.combine_masses(use_hmr=True)),
        system,
        None,
    )


def setup_in_env(st: SingleTopology, host: Host, ligand_conf: np.ndarray, lamb: float, temperature: float, run_seed: int):
    """Host leg environment: combined terms, HMR masses, NPT barostat."""
    system = st.combine_with_host(host.system, lamb, host.num_water_atoms, st.ff, host.host_topology)
    host_hmr_masses = model_utils.apply_hmr(host.physical_masses, host.system.bond.potential.idxs)
    hmr_masses = np.concatenate([host_hmr_masses, st.combine_masses(use_hmr=True)])

    group_idxs = get_group_indices(get_bond_list(system.bond.potential), len(hmr_masses))
    barostat = MonteCarloBarostat(len(hmr_masses), DEFAULT_PRESSURE, temperature, group_idxs, BAROSTAT_INTERVAL, run_seed + 1)
    return np.concatenate([host.conf, ligand_conf]), hmr_masses, system, barostat


def _interacting_ligand_atoms(st: SingleTopology, ligand_idxs, lamb: float):
    """Ligand atoms in the w=0 plane (fully interacting) at this λ."""
    if lamb == 0.0:
        keep = st.c_flags != AtomMapFlags.MOL_B
    elif lamb == 1.0:
        keep = st.c_flags != AtomMapFlags.MOL_A
    else:
        keep = st.c_flags == AtomMapFlags.CORE
    return ligand_idxs[keep]


def param_bytes(terms) -> bytes:
    """The bytes the integrator seed hashes: every potential's f64
    parameters in get_U_fns order."""
    return b"".join(bp.params.detach().cpu().numpy().astype(np.float64, copy=False).tobytes() for bp in terms)


def setup_initial_state(
    st: SingleTopology,
    lamb: float,
    host: Optional[Host],
    temperature: float,
    seed: int,
    device=None,
    dtype=torch.float64,
) -> InitialState:
    """One λ-window's InitialState, potentials on `device` (None: the card),
    with edge-direction-symmetric seeding (the derived seed depends on the
    combined conformer / parameter bytes, not on which molecule is called A)."""
    ligand_conf = st.combine_confs(get_romol_conf(st.mol_a), get_romol_conf(st.mol_b), lamb)
    init_seed = int(seed + bytes_to_id(ligand_conf.tobytes())) % MAX_SEED_VALUE
    device = resolve_device(device)

    if host is not None:
        x0, hmr_masses, system, barostat = setup_in_env(st, host, ligand_conf, lamb, temperature, init_seed)
        box0 = host.box
        protein_idxs = np.arange(0, len(host.physical_masses) - host.num_water_atoms)
        potentials = system.to_system(device=device, dtype=dtype).get_U_fns()
    else:
        x0, box0, hmr_masses, system, barostat = setup_in_vacuum(st, ligand_conf, lamb)
        protein_idxs = np.array([], dtype=np.int32)
        potentials = system.to_system(len(x0), device=device, dtype=dtype).get_U_fns()

    run_seed = int(seed + bytes_to_id(param_bytes(system.get_U_fns()))) % MAX_SEED_VALUE

    n_total = len(x0)
    ligand_idxs = np.arange(n_total - len(ligand_conf), n_total, dtype=np.int32)

    return InitialState(
        potentials,
        LangevinIntegrator(temperature, MD_DT, MD_FRICTION, hmr_masses, run_seed),
        barostat,
        x0,
        sample_velocities(hmr_masses, temperature, init_seed),
        box0,
        lamb,
        ligand_idxs,
        protein_idxs.astype(np.int32),
        interacting_atoms=_interacting_ligand_atoms(st, ligand_idxs, lamb),
    )


def assert_all_states_have_same_masses(initial_states: Sequence[InitialState]):
    masses = np.array([s.integrator.masses for s in initial_states])
    np.testing.assert_array_almost_equal(masses.std(0), 0, err_msg="masses assumed constant w.r.t. lambda")
