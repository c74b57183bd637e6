"""The port's bisection (timemachine_torch/fe/protocol_refinement.py,
fe/energy_decomposition.py, fe/free_energy.py run_sims_bisection) and its
vacuum leg (fe/rbfe.py run_vacuum) against timemachine_tpu.

- greedy_bisection_step: the same refined protocol and (costs, left index,
  new state) as JAX's under the same cost function, ties included.
- compute_energy_decomposed_u_kln on the same frames of tests/test_torch_rbfe.py's
  small windows (λ 0 and 0.4, perturbed from x0 with numpy draws): the exact
  terms within 1e-10 relative of JAX's, the host term within HOST_REL (the
  dense exact-erfc form in both packages; measured 1.2e-15 on these frames,
  1.04e-3 while the port ran the rowscan polynomial, ROADMAP P11), a frame
  with a NaN
  coordinate NaN in every component.
- run_vacuum at tests/test_rbfe_default.py's toy settings (3 windows, so both
  packages' schedule is [0, 0.5, 1]): the same λ schedule as JAX's, finite
  dGs, each HREX iteration's replica permutation a permutation, frames of
  the asked count; the port's renders its plots where matplotlib imports (ROADMAP P21).
- run_sims_bisection's early stop and its MinOverlapWarning, as JAX's, on the
  vacuum windows; the fixed-grid estimator and the bisection estimator
  without HREX in vacuum (the λ grid, finite pairs, the plots rendered).
"""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_rbfe import EXACT_TERMS, HOST, TEMP, small  # noqa: E402, F401  (small: the fixture)
from timemachine_torch.fe import energy_decomposition as ted  # noqa: E402
from timemachine_torch.fe import free_energy as tfe  # noqa: E402
from timemachine_torch.fe import protocol_refinement as tpr  # noqa: E402
from timemachine_torch.fe import rbfe as trbfe  # noqa: E402

torch.set_num_threads(1)  # the suite's workers share the host's cores

HOST_REL = 1e-10
N_FRAMES = 3


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


COSTS = {
    "width": lambda a, b: (b - a) ** 2,
    "tie": lambda a, b: 1.0,
    "skewed": lambda a, b: np.sin(3.0 * a) + (b - a),
    "inf": lambda a, b: np.inf if a == 0.0 else b - a,
}


@pytest.mark.parametrize("cost", sorted(COSTS))
@pytest.mark.parametrize("protocol", [[0.0, 1.0], [0.0, 0.25, 0.5, 1.0], [0.1, 0.3, 0.35, 0.9]])
def test_greedy_bisection_step_matches_jax(protocol, cost):
    from timemachine_tpu.fe import protocol_refinement as jpr

    def midpoint(a, b):
        return (a + b) / 2.0

    t = tpr.greedy_bisection_step(list(protocol), COSTS[cost], midpoint)
    j = jpr.greedy_bisection_step(list(protocol), COSTS[cost], midpoint)
    assert t == j
    assert len(t[0]) == len(protocol) + 1 and t[0] == sorted(t[0])


def _frames(state, seed):
    rng = np.random.default_rng(seed)
    frames = [state.x0 + rng.normal(0.0, 0.002, state.x0.shape) for _ in range(N_FRAMES)]
    return frames, [np.asarray(state.box0)] * N_FRAMES


def test_energy_decomposed_u_kln_matches_jax(small):
    _jax()
    from timemachine_tpu.fe import energy_decomposition as jed

    jstates, tstates = small["jax"][:2], small["port"][:2]
    samples = [_frames(s, 100 + k) for k, s in enumerate(tstates)]
    samples[1][0][1][5, 0] = np.nan  # a corrupt frame
    j_pots = [bp.potential for bp in jstates[0].potentials]
    j_eds = [
        jed.EnergyDecomposedState(f, b, jed.get_batch_u_fns(j_pots, [bp.params for bp in s.potentials], TEMP))
        for (f, b), s in zip(samples, jstates)
    ]
    t_eds = [
        ted.EnergyDecomposedState(f, b, ted.get_batch_u_fns(tstates[0].potentials, [p.params for p in s.potentials], TEMP))
        for (f, b), s in zip(samples, tstates)
    ]
    uj = jed.compute_energy_decomposed_u_kln(j_eds)
    ut = ted.compute_energy_decomposed_u_kln(t_eds)
    assert ut.shape == uj.shape == (len(tstates[0].potentials), 2, 2, N_FRAMES)
    bad = np.zeros(ut.shape, dtype=bool)
    bad[:, 1, :, 1] = True
    assert np.isnan(ut[bad]).all() and np.isnan(uj[bad]).all()
    ok = ~bad
    for comp in range(ut.shape[0]):
        a, b = ut[comp][ok[comp]], uj[comp][ok[comp]]
        rel = HOST_REL if comp == HOST else 1e-10
        assert np.all(np.abs(a - b) <= rel * np.maximum(np.abs(b), 1e-300)), comp
    assert set(EXACT_TERMS) | {HOST} == set(range(ut.shape[0]))


@pytest.fixture(scope="module")
def vacuum_legs():
    """run_vacuum of both packages at tests/test_rbfe_default.py's toy
    settings, from the RBFE cache's conformers."""
    _jax()
    from tests.test_torch_rbfe import NAMES, SMILES, _cache_meta, _edge_inputs
    from timemachine_tpu.fe.free_energy import HREXParams as JHREXParams
    from timemachine_tpu.fe.free_energy import MDParams as JMDParams
    from timemachine_tpu.fe.rbfe import run_vacuum
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.ff import Forcefield

    meta = _cache_meta()
    j_a, j_b, j_core, j_ff = _edge_inputs((meta["conf_a"], meta["conf_b"]))
    t_mols = [mol_from_smiles(s, add_hs=True, name=n) for s, n in zip(SMILES, NAMES)]
    for m, c in zip(t_mols, (meta["conf_a"], meta["conf_b"])):
        m.set_conf(np.asarray(c))
    kw = dict(n_frames=6, n_eq_steps=50, steps_per_frame=20, seed=2026)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = run_vacuum(j_a, j_b, j_core, j_ff, None, md_params=JMDParams(**kw, hrex_params=JHREXParams(n_frames_bisection=2)), n_windows=3)
        t = trbfe.run_vacuum(
            *t_mols, np.asarray(j_core), Forcefield.load_default(), None,
            md_params=tfe.MDParams(**kw, hrex_params=tfe.HREXParams(n_frames_bisection=2)), n_windows=3, device="cpu",
        )
    return j, t


def test_run_vacuum_schedule_matches_jax(vacuum_legs):
    j, t = vacuum_legs
    t_lambdas = [s.lamb for s in t.final_result.initial_states]
    assert t_lambdas == [s.lamb for s in j.final_result.initial_states] == [0.0, 0.5, 1.0]
    assert [[s.lamb for s in r.initial_states] for r in t.intermediate_results] == [
        [s.lamb for s in r.initial_states] for r in j.intermediate_results
    ]


def test_run_vacuum_result_is_finite_and_valid(vacuum_legs):
    _, t = vacuum_legs
    assert isinstance(t, tfe.HREXSimulationResult)
    assert isinstance(t.plots, tfe.PairBarPlots) and isinstance(t.hrex_plots, tfe.HREXPlots)
    assert all(png.startswith(b"\x89PNG") for png in (*vars(t.plots).values(), *vars(t.hrex_plots).values()))
    assert len(t.final_result.dGs) == 2 and np.isfinite(t.final_result.dGs).all() and np.isfinite(t.final_result.dG_errs).all()
    assert len(t.trajectories) == 3
    for traj in t.trajectories:
        assert len(traj.frames) == 6 and np.isfinite(traj.frames[-1]).all()
    perms = t.hrex_diagnostics.replica_idx_by_state_by_iter
    assert len(perms) == 6
    for perm in perms:
        assert sorted(perm) == [0, 1, 2]


def _vacuum_state_fn(small):
    """λ -> the edge's vacuum window on the CPU, through the port's builder."""
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.fe.single_topology import SingleTopology
    from timemachine_torch.ff import Forcefield

    st = small["st"]
    mols = []
    for m in (st.mol_a, st.mol_b):
        tm = mol_from_smiles({"ethanol": "CCO", "propane": "CCC"}[m.name], add_hs=True, name=m.name)
        tm.set_conf(np.asarray(m.get_conf()))
        mols.append(tm)
    tst = SingleTopology(mols[0], mols[1], np.asarray(st.core), Forcefield.load_default())
    return lambda lamb: trbfe.setup_initial_state(tst, lamb, None, TEMP, 2023, device="cpu")


BISECT_MD = dict(n_frames=4, n_eq_steps=20, steps_per_frame=10, seed=2023)


def test_run_sims_bisection_warns_below_min_overlap(small):
    """No bisection allowed and an overlap target no pair reaches: one
    result, MinOverlapWarning (JAX's warning class under the port's name)."""
    with pytest.warns(tfe.MinOverlapWarning):
        results, trajs = tfe.run_sims_bisection(
            [0.0, 1.0], _vacuum_state_fn(small), tfe.MDParams(**BISECT_MD), n_bisections=0, temperature=TEMP,
            min_overlap=0.999, verbose=False,
        )
    assert len(results) == 1 and len(trajs) == 2 and len(results[0].bar_results) == 1


def test_run_sims_bisection_stops_once_overlaps_exceed_min_overlap(small):
    with warnings.catch_warnings():
        warnings.simplefilter("error", tfe.MinOverlapWarning)
        results, trajs = tfe.run_sims_bisection(
            [0.0, 0.5, 1.0], _vacuum_state_fn(small), tfe.MDParams(**BISECT_MD), n_bisections=3, temperature=TEMP,
            min_overlap=1e-300, verbose=False,
        )
    assert len(results) == 1 and [s.lamb for s in results[0].initial_states] == [0.0, 0.5, 1.0] and len(trajs) == 3


def _vacuum_edge():
    """The edge's molecules and core from the RBFE cache's conformers (port)."""
    from tests.test_torch_rbfe import NAMES, SMILES, _cache_meta
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS
    from timemachine_torch.fe.atom_mapping import get_cores
    from timemachine_torch.ff import Forcefield

    meta = _cache_meta()
    mols = [mol_from_smiles(s, add_hs=True, name=n) for s, n in zip(SMILES, NAMES)]
    for m, c in zip(mols, (meta["conf_a"], meta["conf_b"])):
        m.set_conf(np.asarray(c))
    return mols[0], mols[1], get_cores(*mols, **DEFAULT_ATOM_MAPPING_KWARGS)[0], Forcefield.load_default()


def test_fixed_grid_and_plain_bisection_estimators_in_vacuum():
    """estimate_relative_free_energy on a linear 3-window grid, and run_vacuum
    without HREXParams (estimate_relative_free_energy_bisection): each a
    SimulationResult of 2 finite pairs over λ 0, 0.5, 1, its plots rendered."""
    mol_a, mol_b, core, ff = _vacuum_edge()
    md = tfe.MDParams(**BISECT_MD)
    fixed = trbfe.estimate_relative_free_energy(mol_a, mol_b, core, ff, None, n_windows=3, md_params=md, device="cpu")
    bisected = trbfe.run_vacuum(mol_a, mol_b, core, ff, None, md_params=md, n_windows=3, device="cpu")
    for res in (fixed, bisected):
        assert type(res) is tfe.SimulationResult and isinstance(res.plots, tfe.PairBarPlots)
        assert [s.lamb for s in res.final_result.initial_states] == [0.0, 0.5, 1.0]
        assert len(res.final_result.dGs) == 2 and np.isfinite(res.final_result.dGs).all()
    assert fixed.intermediate_results == [] and len(bisected.intermediate_results) == 2
