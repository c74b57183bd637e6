"""Small replica ladders of the port for the replica-mesh tests, built the
same way in the parent process and in every rank (no JAX): four replicas
of tests/test_torch_hrex_resume.py's water box (bonds, angles, a barostat
every 3 steps, optionally the TIBD water sampler every 10 steps) and four
of JAX's harmonic states (tests/test_free_energy.py make_harmonic_state)
for run_sims_hrex. pytest does not collect this module.
"""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch import potentials as tp
from timemachine_torch.fe import free_energy as tfe
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.context import Context
from timemachine_torch.md.exchange.exchange_mover import random_rotation_matrix
from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove
from timemachine_torch.parallel.replica_exchange import ReplicaExchangeRunner

CPU = torch.device("cpu")
TEMP = 300.0
K = 4
N_WATERS, BOX_NM = 18, 2.0


def _water_box(seed):
    rng = np.random.default_rng(seed)
    template = np.array([[0.0, 0, 0], [0.09572, 0, 0], [-0.024, 0.0927, 0]])
    conf = np.concatenate([template @ random_rotation_matrix(rng).T + rng.uniform(0, BOX_NM, 3) for _ in range(N_WATERS)])
    params = np.zeros((3 * N_WATERS, 4))
    q = np.sqrt(138.935456)
    params[0::3, 0], params[1::3, 0], params[2::3, 0] = -0.834 * q, 0.417 * q, 0.417 * q
    params[0::3, 1], params[0::3, 2] = 0.315 / 2, np.sqrt(0.635)
    return conf, params


def water_runner(with_sampler: bool, mesh=None):
    """(runner, start) of K = 4 replicas of the water box over `mesh`."""
    confs = [_water_box(s) for s in (31, 32, 33, 34)]
    n = 3 * N_WATERS
    waters = np.arange(n).reshape(N_WATERS, 3)
    bonds = np.concatenate([waters[:, [0, 1]], waters[:, [0, 2]]])
    bond = tp.HarmonicBond(bonds, np.tile([4e5, 0.09572], (len(bonds), 1)), n, device=CPU)
    angle = tp.HarmonicAngle(waters[:, [1, 0, 2]], np.tile([400.0, 1.8242, 0.0], (N_WATERS, 1)), n, device=CPU)
    masses = np.tile([16.0, 2.0, 2.0], N_WATERS)
    movers = [MonteCarloBarostat(n, 1.013, TEMP, list(waters), interval=3, seed=2024)]
    params = confs[0][1]
    water_params = None
    if with_sampler:
        movers.append(TIBDExchangeMove(n, np.arange(3), waters[1:], params, TEMP, 2.0, 1.2, 0.7, seed=22,
                                       n_proposals=30, interval=10))
        water_params = [np.where(np.arange(n)[:, None] < 3, params * (1.0 - 0.3 * k), params) for k in range(K)]
    ctx = Context(confs[0][0], np.zeros((n, 3)), np.eye(3) * BOX_NM, LangevinIntegrator(TEMP, 1.5e-3, 1.0, masses, seed=7),
                  [bond, angle], movers, device=CPU)
    runner = ReplicaExchangeRunner(
        ctx, [[bond.params * (1.0 + 0.1 * k), angle.params] for k in range(K)], temperature=TEMP,
        neighbor_pairs=[(k, k + 1) for k in range(K - 1)], n_swap_attempts_per_iter=K**3, max_delta_states=2, seed=13,
        water_params_by_state=water_params, mesh=mesh,
    )
    start = ([c for c, _ in confs], [np.zeros((n, 3))] * K, [np.eye(3) * BOX_NM] * K)
    return runner, start


def harmonic_states():
    """JAX's make_harmonic_state at K = 4 values of lambda, with a barostat-free 10 nm box."""
    states = []
    for lamb in np.linspace(0.0, 1.0, K):
        x0 = np.array([[0.0, 0, 0], [0.12, 0, 0]])
        bond = tp.HarmonicBond(np.array([[0, 1]], dtype=np.int32), np.array([[20000.0 * (1.0 + lamb), 0.11]]), 2,
                               device=CPU)
        intg = LangevinIntegrator(TEMP, 1.5e-3, 1.0, np.array([12.0, 12.0]), seed=5)
        states.append(tfe.InitialState([bond], intg, None, x0, np.zeros_like(x0), np.eye(3) * 10.0, float(lamb),
                                        np.array([0], dtype=np.int32), np.array([], dtype=np.int32)))
    return states


def sims_hrex_arrays(states) -> dict:
    """run_sims_hrex over the states (4 frames of 20 steps after 10) as arrays."""
    md = tfe.MDParams(n_frames=4, n_eq_steps=10, steps_per_frame=20, seed=2026,
                      hrex_params=tfe.HREXParams(n_frames_bisection=1))
    pair_bar, trajs, diagnostics, _ = tfe.run_sims_hrex(states, md, print_diagnostics_interval=None)
    return dict(
        dGs=np.asarray(pair_bar.dGs), frames=np.stack([np.stack(list(t.frames)) for t in trajs]),
        boxes=np.stack([np.stack(t.boxes) for t in trajs]), final_v=np.stack([t.final_velocities for t in trajs]),
        perms=np.asarray(diagnostics.replica_idx_by_state_by_iter),
    )
