"""The port's absolute hydration leg, windowed (timemachine_torch/fe/free_energy.py
AbsoluteFreeEnergy, timemachine_torch/fe/absolute_hydration.py) against
timemachine_tpu's, and the AHFE case of tests/test_potential_matrix.py.

Both packages get ethanol at the RBFE cache's conformer (the JAX package's
embedding) and each its own water box of the same seed. The port runs in
float64 on the CPU, JAX in x64 on the CPU; each host term takes JAX's CPU
form, the dense one (potentials.all_pairs_kernel). prepare_host_edge is held
at three λ (index arrays equal, parameters within PARAM_TOL of each column's
largest |value|, masses bitwise); setup_initial_states at 3 windows in a
2.5 nm box (the smallest the port's Context takes over twice the 1.2 nm
cutoff) with the host's FIRE cut to FIRE_STEPS a window in both packages (a
dense float64 force takes 0.17 s on one CPU thread here): masses, seeds,
box, ligand atoms, x0 within X0_TOL nm; every window's energy and force per
term within ENERGY_REL; the interaction group exactly 0 at λ = 1. The port's
estimate_absolute_free_energy runs at a tiny depth, twice, bitwise.

The AHFE case of tests/test_potential_matrix.py::test_overflow_to_inf_mbar_end_to_end
(ROADMAP R3): there `params_b` is a copy of `params_a`, so its two states
are one; here state B's ligand charges are perturbed, and the test checks
that the states differ before it holds the clash and NaN semantics and the
clean frames' u_kln against JAX's.
"""

import warnings

import numpy as np
import pytest
import torch

from timemachine_torch.chem import mol_from_smiles as t_mol_from_smiles
from timemachine_torch.fe import absolute_hydration as tah
from timemachine_torch.fe import free_energy as tfe
from timemachine_torch.fe.lambda_schedule import construct_pre_optimized_absolute_lambda_schedule_solvent
from timemachine_torch.fe.topology import BaseTopology as TBT
from timemachine_torch.ff import Forcefield as TF
from timemachine_torch.md import builders as tb
from timemachine_torch.md import minimizer as tmin
from timemachine_torch.testsystems import rbfe_solvent

torch.set_num_threads(1)  # the suite's workers share the host's cores

PARAM_TOL = 1e-12  # of each parameter column's largest |value|
X0_TOL = 1e-8  # nm, FIRE's coordinates after 2 x FIRE_STEPS steps in float64
ENERGY_REL = 1e-10  # each term's energy, and its force on its own norm
FIRE_STEPS = 30  # a window: enough to pass fire_minimize_host's force check at BOX
BOX = 2.5  # nm
CPU = torch.device("cpu")


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def ethanol():
    """Both packages' ethanol, force field and a BOX nm water box around it."""
    _jax()
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.ff import Forcefield as JF
    from timemachine_tpu.md.builders import build_water_system

    conf = rbfe_solvent.metadata(rbfe_solvent.load_arrays())["conf_a"]
    j_mol = j_mol_from_smiles("CCO", add_hs=True, name="ethanol")
    t_mol = t_mol_from_smiles("CCO", add_hs=True, name="ethanol")
    for m in (j_mol, t_mol):
        m.set_conf(np.asarray(conf))
    jff, tff = JF.load_default(), TF.load_default()
    return dict(
        j_mol=j_mol, t_mol=t_mol, jff=jff, tff=tff,
        j_host=build_water_system(BOX, jff.water_ff, mols=[j_mol]),
        t_host=tb.build_water_system(BOX, tff.water_ff, mols=[t_mol]),
    )


def _afes(e):
    from timemachine_tpu.fe.free_energy import AbsoluteFreeEnergy as JAFE
    from timemachine_tpu.fe.topology import BaseTopology as JBT

    return JAFE(e["j_mol"], JBT(e["j_mol"], e["jff"])), tfe.AbsoluteFreeEnergy(e["t_mol"], TBT(e["t_mol"], e["tff"]))


INDEX_FIELDS = ("idxs", "exclusion_idxs", "scale_factors", "atom_idxs", "row_atom_idxs", "col_atom_idxs", "num_atoms",
                "beta", "cutoff")


def _assert_terms_equal(j_pots, j_params, t_pots, t_params):
    assert [type(p).__name__ for p in t_pots] == [type(p).__name__ for p in j_pots]
    for jp, tp, jpar, tpar in zip(j_pots, t_pots, j_params, t_params):
        name = type(jp).__name__
        for f in INDEX_FIELDS:
            if hasattr(jp, f):
                a, b = getattr(jp, f), getattr(tp, f)
                assert (a is None) == (b is None), (name, f)
                if a is not None:
                    np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=f"{name}.{f}")
        a, b = np.asarray(jpar, np.float64), _np(tpar)
        assert a.shape == b.shape, name
        if a.size:
            scale = np.maximum(np.abs(a).reshape(a.shape[0], -1).max(0), 1e-300)
            err = (np.abs(b - a).reshape(a.shape[0], -1) / scale).max()
            assert err <= PARAM_TOL, (name, err)


@pytest.mark.parametrize("lamb", [0.0, 0.5, 1.0])
def test_prepare_host_edge_matches_jax(ethanol, lamb):
    j_afe, t_afe = _afes(ethanol)
    j_pots, j_params, j_masses = j_afe.prepare_host_edge(ethanol["jff"], ethanol["j_host"], lamb)
    t_pots, t_params, t_masses = t_afe.prepare_host_edge(ethanol["tff"], ethanol["t_host"], lamb)
    _assert_terms_equal(j_pots, j_params, t_pots, t_params)
    np.testing.assert_array_equal(t_masses, np.asarray(j_masses))
    # the host term never sees the ligand; the ligand's w is λ cutoff in the interaction group
    n_host = ethanol["t_host"].conf.shape[0]
    host_term = t_pots[4]
    np.testing.assert_array_equal(host_term.atom_idxs, np.arange(n_host))
    w = _np(t_params[5])[n_host:, 3]
    np.testing.assert_array_equal(w, lamb * host_term.cutoff * np.ones_like(w))


def test_prepare_vacuum_edge_and_combined_coords_match_jax(ethanol):
    j_afe, t_afe = _afes(ethanol)
    j_pots, j_params, j_masses = j_afe.prepare_vacuum_edge(ethanol["jff"])
    t_pots, t_params, t_masses = t_afe.prepare_vacuum_edge(ethanol["tff"])
    _assert_terms_equal(j_pots, j_params, t_pots, t_params)
    np.testing.assert_array_equal(t_masses, np.asarray(j_masses))
    host = ethanol["t_host"].conf
    np.testing.assert_array_equal(t_afe.prepare_combined_coords(host), j_afe.prepare_combined_coords(host))
    np.testing.assert_array_equal(t_afe.prepare_combined_coords(), j_afe.prepare_combined_coords())


@pytest.fixture(scope="module")
def states(ethanol):
    """setup_initial_states in both packages at 3 windows, decoupled -> coupled, FIRE cut to FIRE_STEPS a window."""
    from timemachine_tpu.fe import absolute_hydration as jah
    from timemachine_tpu.md import minimizer as jmin

    schedule = construct_pre_optimized_absolute_lambda_schedule_solvent(3)[::-1]
    j_afe, t_afe = _afes(ethanol)
    j_fire, t_fire = jmin.fire_minimize_host, tmin.fire_minimize_host
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmin, "fire_minimize_host", lambda *a, **k: j_fire(*a, n_steps_per_window=FIRE_STEPS, **k))
        mp.setattr(tmin, "fire_minimize_host", lambda *a, **k: t_fire(*a, n_steps_per_window=FIRE_STEPS, **k))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            j_states = jah.setup_initial_states(j_afe, ethanol["jff"], ethanol["j_host"], 300.0, schedule, 2023)
        t_states = tah.setup_initial_states(t_afe, ethanol["tff"], ethanol["t_host"], 300.0, schedule, 2023, device=CPU)
    return j_states, t_states


def test_setup_initial_states_matches_jax(states):
    j_states, t_states = states
    assert len(t_states) == len(j_states) == 3
    for js, ts in zip(j_states, t_states):
        assert ts.lamb == js.lamb
        np.testing.assert_array_equal(ts.integrator.masses, np.asarray(js.integrator.masses))
        assert (ts.integrator.seed, ts.integrator.dt, ts.integrator.friction, ts.integrator.temperature) == (
            js.integrator.seed, js.integrator.dt, js.integrator.friction, js.integrator.temperature)
        jb, tb_ = js.barostat, ts.barostat
        assert (tb_.seed, tb_.interval, tb_.pressure, tb_.temperature) == (jb.seed, jb.interval, jb.pressure, jb.temperature)
        assert len(tb_.group_idxs) == len(jb.group_idxs)
        assert all(np.array_equal(a, b) for a, b in zip(tb_.group_idxs, jb.group_idxs))
        np.testing.assert_array_equal(ts.box0, np.asarray(js.box0))
        np.testing.assert_array_equal(ts.ligand_idxs, np.asarray(js.ligand_idxs))
        np.testing.assert_array_equal(ts.v0, np.asarray(js.v0))
        assert np.abs(ts.x0 - np.asarray(js.x0)).max() <= X0_TOL
    # every window the same seeds and the same x0
    assert len({s.integrator.seed for s in t_states}) == 1 and len({s.barostat.seed for s in t_states}) == 1
    assert all(np.array_equal(s.x0, t_states[0].x0) for s in t_states)


def _jax_energy_force(bp, x, box):
    jax = _jax()
    fn = lambda xx: bp.potential(xx, bp.params, box)
    return float(fn(x)), -np.asarray(jax.grad(fn)(x))


@pytest.mark.parametrize("window", [0, 1, 2])
def test_window_energy_and_force_match_jax(states, window):
    j_states, t_states = states
    js, ts = j_states[window], t_states[window]
    tfe.configure_all_pairs(ts)
    assert [type(p).__name__ for p in ts.potentials] == [type(bp.potential).__name__ for bp in js.potentials]
    x, box = np.asarray(js.x0), np.asarray(js.box0)
    xt, boxt = torch.as_tensor(x), torch.as_tensor(box)
    for bp, pot in zip(js.potentials, ts.potentials):
        u_j, f_j = _jax_energy_force(bp, x, box)
        with torch.no_grad():
            u_t, f_t = (_np(a) for a in pot.energy_force(xt, boxt))
        name = type(pot).__name__
        assert abs(float(u_t) - u_j) <= ENERGY_REL * max(abs(u_j), 1.0), (name, float(u_t), u_j)
        assert np.linalg.norm(f_t - f_j) <= ENERGY_REL * max(np.linalg.norm(f_j), 1.0), name


def test_interaction_group_is_zero_when_decoupled(states):
    _, t_states = states
    s = t_states[0]
    assert s.lamb == 1.0
    ixn = next(p for p in s.potentials if isinstance(p, tfe.NonbondedInteractionGroup))
    with torch.no_grad():
        u, f = ixn.energy_force(torch.as_tensor(s.x0), torch.as_tensor(s.box0))
    assert float(u) == 0.0 and not torch.any(f != 0)
    # coupled (λ = 0) it is not
    ixn0 = next(p for p in t_states[-1].potentials if isinstance(p, tfe.NonbondedInteractionGroup))
    assert float(ixn0.energy(torch.as_tensor(s.x0), torch.as_tensor(s.box0))) != 0.0


def test_estimate_absolute_free_energy_is_finite_and_bitwise_on_repeat(ethanol, states, monkeypatch):
    """The leg's driver at a tiny depth (the host's FIRE as the fixture's: it is held above)."""
    _, t_states = states
    host_conf = t_states[0].x0[: ethanol["t_host"].conf.shape[0]]
    monkeypatch.setattr(tmin, "fire_minimize_host", lambda *a, **k: host_conf.copy())
    md = tfe.MDParams(n_frames=2, n_eq_steps=4, steps_per_frame=4, seed=2023)
    runs = []
    for _ in range(2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = tah.estimate_absolute_free_energy(ethanol["t_mol"], ethanol["tff"], ethanol["t_host"], md_params=md,
                                                    n_windows=3, device=CPU)
        runs.append(res)
    fin = runs[0].final_result
    assert len(fin.bar_results) == 2 and isinstance(runs[0].plots, tfe.PairBarPlots)
    assert np.isfinite(fin.dGs).all() and np.isfinite(fin.dG_errs).all()
    assert [s.lamb for s in fin.initial_states] == [s.lamb for s in t_states]
    for a, b in zip(runs[0].trajectories, runs[1].trajectories):
        assert all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames))
    np.testing.assert_array_equal(runs[1].final_result.dGs, fin.dGs)
    # the interaction group's energy at λ = 1 (window 0's parameters, l = 0) is exactly 0 on every frame
    ixn = [type(p).__name__ for p in fin.initial_states[0].potentials].index("NonbondedInteractionGroup")
    u_ixn = fin.bar_results[0].u_kln_by_component[ixn]
    assert np.all(u_ixn[:, 0] == 0.0) and np.all(u_ixn[:, 1] != 0.0)


# -- the AHFE case of tests/test_potential_matrix.py, with state B distinct (R3) --------------------------


@pytest.fixture(scope="module")
def solvent_state(ethanol):
    """The AHFE window at λ = 0.1 in the BOX nm box, in both packages:
    (JAX bound potentials, the port's modules, x0, box)."""
    j_afe, t_afe = _afes(ethanol)
    j_pots, j_params, _ = j_afe.prepare_host_edge(ethanol["jff"], ethanol["j_host"], 0.1)
    t_pots, t_params, _ = t_afe.prepare_host_edge(ethanol["tff"], ethanol["t_host"], 0.1)
    from timemachine_torch.convert import modules_from_bound_potentials

    x0 = t_afe.prepare_combined_coords(host_coords=ethanol["t_host"].conf)
    modules = modules_from_bound_potentials([p.bind(q) for p, q in zip(t_pots, t_params)], len(x0), CPU)
    box = ethanol["t_host"].box
    tmin.configure_nonbonded(modules, torch.as_tensor(x0), torch.as_tensor(box), site="context")
    return [p.bind(q) for p, q in zip(j_pots, j_params)], modules, x0, box


def test_overflow_to_inf_mbar_end_to_end_with_distinct_states(solvent_state):
    from timemachine_tpu.fe.energy_decomposition import EnergyDecomposedState as JEDS
    from timemachine_tpu.fe.energy_decomposition import compute_energy_decomposed_u_kln as j_u_kln
    from timemachine_tpu.fe.energy_decomposition import get_batch_u_fns as j_batch_u_fns
    from timemachine_torch.fe.energy_decomposition import EnergyDecomposedState, compute_energy_decomposed_u_kln
    from timemachine_torch.fe.energy_decomposition import get_batch_u_fns

    j_bps, modules, x0, box = solvent_state
    rng = np.random.default_rng(7)
    frames = [x0 + rng.normal(0, 1e-3, x0.shape) for _ in range(4)]
    clash = frames[1].copy()
    clash[0] = clash[-9] + 1e-28  # a water O fused onto the ligand's first carbon
    frames[1] = clash
    nan_frame = frames[2].copy()
    nan_frame[5, 2] = np.nan
    frames[2] = nan_frame
    boxes = np.repeat(np.asarray(box)[None], len(frames), axis=0)

    params_a = [_np(m.params).copy() for m in modules]
    params_b = [p.copy() for p in params_a]
    # state B: the ligand's charges in the interaction group and its pair list scaled by 0.9
    n_lig = 9
    ixn = [type(m).__name__ for m in modules].index("NonbondedInteractionGroup")
    pairs = [type(m).__name__ for m in modules].index("NonbondedPairListPrecomputed")
    params_b[ixn][-n_lig:, 0] *= 0.9
    params_b[pairs][:, 0] *= 0.81  # q_i q_j
    assert any(not np.array_equal(a, b) for a, b in zip(params_a, params_b))

    def u_kln(batch_u_fns, state_cls, decomposed, pots, to):
        states = [state_cls(frames, boxes, batch_u_fns(pots, [to(p) for p in ps])) for ps in (params_a, params_b)]
        return decomposed(states)

    t = u_kln(get_batch_u_fns, EnergyDecomposedState, compute_energy_decomposed_u_kln, modules, torch.as_tensor)
    j = u_kln(j_batch_u_fns, JEDS, j_u_kln, [bp.potential for bp in j_bps], np.asarray)
    total = t.sum(0)
    # the two states differ on the clean frames, and only through the ligand's terms
    for comp in range(len(modules)):
        same = np.array_equal(t[comp, :, 0, [0, 3]], t[comp, :, 1, [0, 3]])
        assert same == (comp not in (ixn, pairs)), comp
    # the clean frames against JAX's, each component on its own scale
    clean = [0, 3]
    for comp in range(len(modules)):
        a, b = t[comp][..., clean], j[comp][..., clean]
        assert np.abs(a - b).max() <= ENERGY_REL * max(np.abs(b).max(), 1.0), comp
    # the clash: a reduced energy over 10 times the clean frames' largest in both packages, and the
    # same number; the NaN frame non-finite in both
    j_total = j.sum(0)
    assert np.all(total[:, :, 1] > 10 * np.abs(total[:, :, clean]).max())
    assert np.abs(total[:, :, 1] - j_total[:, :, 1]).max() <= ENERGY_REL * np.abs(j_total[:, :, 1]).max()
    assert not np.isfinite(total[0, 0, 2]) and not np.isfinite(j_total[0, 0, 2])
    assert np.isfinite(total[:, :, 0]).all() and np.isfinite(total[:, :, 3]).all()

    with warnings.catch_warnings():
        warnings.simplefilter("error", tfe.IndeterminateEnergyWarning)
        with pytest.raises(tfe.IndeterminateEnergyWarning):
            tfe.estimate_free_energy_bar(t.copy(), 300.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = tfe.estimate_free_energy_bar(t, 300.0)
    assert np.isfinite(res.dG) and np.isfinite(res.dG_err)
