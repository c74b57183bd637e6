"""HREX sampling of a hindered biphenyl torsion in vacuum: replica exchange
over a softened-torsion ladder crosses the barrier that plain MD cannot
(counterpart of examples/biphenyl_torsion_sampling_hrex.py).

    python -m timemachine_torch.examples.biphenyl_torsion_sampling_hrex [--n_states 8] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from timemachine_torch.constants import DEFAULT_TEMP
from timemachine_torch.convert import modules_from_bound_potentials
from timemachine_torch.device import resolve_device, working_dtype
from timemachine_torch.fe.free_energy import HREXParams, InitialState, MDParams, run_sims_hrex
from timemachine_torch.fe.topology import BaseTopology
from timemachine_torch.fe.utils import get_mol_masses, get_romol_conf
from timemachine_torch.ff import Forcefield
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.utils import sample_velocities
from timemachine_torch.testsystems.ligands import get_biphenyl


def dihedral(x, idxs):
    i, j, k, l = idxs
    b1, b2, b3 = x[j] - x[i], x[k] - x[j], x[l] - x[k]
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    m1 = np.cross(n1, b2 / np.linalg.norm(b2))
    return np.arctan2(np.dot(m1, n2), np.dot(n1, n2))


def make_state(mol, ff, lamb: float, torsion_scale_max: float, seed: int, device=None) -> InitialState:
    """Vacuum state with proper-torsion k scaled by 1/T(lambda): lambda=0 is
    the physical state, lambda=1 the maximally softened one. Its potentials
    are the port's modules on `device` (None: the card)."""
    bt = BaseTopology(mol, ff)
    params_pt, pt = bt.parameterize_proper_torsion(ff.pt_handle.params)
    params_hb, hb = bt.parameterize_harmonic_bond(ff.hb_handle.params)
    params_ha, ha = bt.parameterize_harmonic_angle(ff.ha_handle.params)
    params_it, it = bt.parameterize_improper_torsion(ff.it_handle.params)
    params_nb, nb = bt.parameterize_nonbonded(
        ff.q_handle.params, ff.q_handle_intra.params, ff.lj_handle.params, ff.lj_handle_intra.params, 0.0
    )

    temperature_scale = 1.0 + (torsion_scale_max - 1.0) * lamb
    params_pt = torch.as_tensor(params_pt).detach().clone()
    params_pt[:, 0] /= temperature_scale

    bps = [hb.bind(params_hb), ha.bind(params_ha), pt.bind(params_pt), it.bind(params_it), nb.bind(params_nb)]
    device = resolve_device(device)
    potentials = modules_from_bound_potentials(bps, mol.num_atoms, device, working_dtype(device))
    x0 = get_romol_conf(mol)
    masses = np.array([float(m) for m in get_mol_masses(mol)])
    intg = LangevinIntegrator(DEFAULT_TEMP, 1.5e-3, 1.0, masses, seed)
    v0 = sample_velocities(masses, DEFAULT_TEMP, seed)
    return InitialState(
        potentials, intg, None, x0, v0, np.eye(3) * 10.0, lamb,
        np.arange(mol.num_atoms, dtype=np.int32), np.array([], dtype=np.int32),
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="Biphenyl torsion sampling with HREX")
    parser.add_argument("--n_states", type=int, default=8)
    parser.add_argument("--n_frames", type=int, default=200)
    parser.add_argument("--steps_per_frame", type=int, default=100)
    parser.add_argument("--max_temperature_scale", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=2023)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    mol, torsion_idxs = get_biphenyl()
    ff = Forcefield.load_default()

    lambdas = np.linspace(0.0, 1.0, args.n_states)
    states = [make_state(mol, ff, lamb, args.max_temperature_scale, args.seed, args.device) for lamb in lambdas]

    md_params = MDParams(
        n_frames=args.n_frames,
        n_eq_steps=1000,
        steps_per_frame=args.steps_per_frame,
        seed=args.seed,
        hrex_params=HREXParams(n_frames_bisection=1, max_delta_states=None),
    )
    pair_bar, trajs, diag, _ = run_sims_hrex(states, md_params, print_diagnostics_interval=50)

    phi_by_state = [np.array([dihedral(frame, torsion_idxs[0]) for frame in traj.frames]) for traj in trajs]
    print("swap acceptance (final cumulative):", np.round(diag.cumulative_swap_acceptance_rates[-1], 3))
    print("physical-state torsion angles sampled:", np.round(np.unique(np.sign(phi_by_state[0])), 2))
    barrier_crossed = len(np.unique(np.sign(phi_by_state[0][np.abs(phi_by_state[0]) > 0.5]))) > 1
    print("torsion barrier crossed in physical state:", bool(barrier_crossed))
    return pair_bar, trajs, diag


if __name__ == "__main__":
    main()
