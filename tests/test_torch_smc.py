"""The port's SMC, enhanced sampling, alignment, protocol optimization and MD
moves (timemachine_torch/md/smc.py, md/enhanced.py, ops/rmsd.py,
optimize/protocol.py, md/moves.py's NVTMove and NPTMove, fe/absolute_hydration.py's
generate_endstate_samples) against timemachine_tpu's.

The cases of tests/test_smc_enhanced.py run on the port, and each is held
against the JAX package where it has the function, fed the same numpy
inputs (JAX x64 on the CPU, the port in float64 on the CPU):
- SMC on the Gaussian ladder, fixed and adaptive: the port's run with a
  RandomState(seed) is bitwise JAX's after np.random.seed(seed) (ROADMAP
  P25), and its free energy is the analytic one;
- the resamplers' draws and weights bitwise, ESS and CESS within 1e-12;
- Kabsch alignment within ALIGN_TOL nm on random conformers and on one
  whose best fit is a reflection; rmsd_align, the restraint;
- VacuumState's three energies, generate_log_weighted_samples' weights for
  given conformers, align_and_replace, within ENERGY_REL;
- the greedy protocol on the Gaussian ladder, the work-stddev distance;
- two steps of simulate_batch from JAX's start given JAX's noise (its
  jax.random draws, rebuilt here), within STEP_TOL nm;
- generate_endstate_samples given the same draws, bitwise;
- get_solvent_phase_system's terms, parameters, masses, coordinates, box;
- a short NPTMove chain on the port: bitwise on repeat, its step counter
  carried across moves (the barostat fires on the global step), set_params
  without a rebuild.
"""

import functools
import warnings

import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from timemachine_torch.chem import mol_from_smiles as t_mol_from_smiles
from timemachine_torch.ff import Forcefield as TF
from timemachine_torch.md import enhanced as te
from timemachine_torch.md import smc as tsmc
from timemachine_torch.md.states import CoordsVelBox
from timemachine_torch.ops import rmsd as trmsd
from timemachine_torch.optimize import protocol as tprot
from timemachine_torch.testsystems import rbfe_solvent

torch.set_num_threads(1)  # the suite's workers share the host's cores

CPU = torch.device("cpu")
ALIGN_TOL = 1e-12  # nm
ENERGY_REL = 1e-12
STEP_TOL = 1e-10  # nm and nm/ps after two Langevin steps in float64


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _jsmc():
    _jax()
    from timemachine_tpu.md import smc as jsmc

    return jsmc


# -- smc ----------------------------------------------------------------------------------------


def _gaussian_smc_setup(n_walkers=100, seed=0):
    """λ takes the standard deviation from 1 to 0.5; the free energy is known."""
    rng = np.random.default_rng(seed)

    def u(x, lam):
        sigma = 1.0 - 0.5 * lam
        return 0.5 * np.square(x).sum() / sigma**2

    def propagate(xs, lam):
        sigma = 1.0 - 0.5 * lam
        return [sigma * rng.normal(size=np.shape(x)) for x in xs]

    def log_prob(xs, lam, first=True):
        return np.array([-u(x, lam) for x in xs])

    samples = [rng.normal(size=(1,)) for _ in range(n_walkers)]
    return samples, propagate, log_prob


def _assert_smc_results_equal(a, b):
    assert a.keys() == b.keys()
    for k in ("log_weights_traj", "ancestry_traj", "incremental_log_weights_traj", "lambdas_traj"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(a["traj"]) == len(b["traj"])
    for sa, sb in zip(a["traj"], b["traj"]):
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))


def test_smc_fixed_schedule_free_energy_is_jax_bitwise():
    jsmc = _jsmc()
    lambdas = np.linspace(0, 1, 11)
    results = []
    for mod, resample in (
        (tsmc, functools.partial(tsmc.conditional_multinomial_resample, rng=np.random.RandomState(5))),
        (jsmc, jsmc.conditional_multinomial_resample),
    ):
        np.random.seed(5)
        samples, propagate, log_prob = _gaussian_smc_setup()
        find_next = functools.partial(mod.fixed_find_next_lambda, log_prob=log_prob, lambdas=lambdas)
        results.append(mod.sequential_monte_carlo(samples, propagate, log_prob, resample, find_next))
    res = results[0]
    final = res["log_weights_traj"][-1]
    assert -(logsumexp(final) - np.log(len(final))) == pytest.approx(-np.log(0.5), abs=0.15)
    assert res["lambdas_traj"][0] == 0.0 and res["lambdas_traj"][-1] == 1.0
    _assert_smc_results_equal(*results)


def test_smc_adaptive_schedule_is_jax_bitwise():
    jsmc = _jsmc()
    results = []
    for mod, resample in (
        (tsmc, functools.partial(tsmc.multinomial_resample, rng=np.random.RandomState(3))),
        (jsmc, jsmc.multinomial_resample),
    ):
        np.random.seed(3)
        samples, propagate, log_prob = _gaussian_smc_setup(seed=3)
        find_next = functools.partial(mod.adaptive_find_next_lambda, log_prob=log_prob, cess_target=50.0)
        results.append(mod.sequential_monte_carlo(samples, propagate, log_prob, resample, find_next))
    lambdas = results[0]["lambdas_traj"]
    assert lambdas[0] == 0.0 and lambdas[-1] == 1.0 and np.all(np.diff(lambdas) > 0)
    final = results[0]["log_weights_traj"][-1]
    assert -(logsumexp(final) - np.log(len(final))) == pytest.approx(-np.log(0.5), abs=0.2)
    _assert_smc_results_equal(*results)


@pytest.mark.parametrize("name", ["identity_resample", "multinomial_resample", "stratified_resample"])
def test_resamplers_preserve_weight_mass_and_match_jax(name):
    jsmc = _jsmc()
    log_weights = np.random.default_rng(1).normal(size=64)
    t_fn, j_fn = getattr(tsmc, name), getattr(jsmc, name)
    kw = {} if name == "identity_resample" else {"rng": np.random.RandomState(17)}
    t_idxs, t_lw = t_fn(log_weights, **kw)
    np.random.seed(17)
    j_idxs, j_lw = j_fn(log_weights)
    assert len(t_idxs) == 64
    assert logsumexp(t_lw) == pytest.approx(logsumexp(log_weights), abs=1e-8)
    np.testing.assert_array_equal(t_idxs, j_idxs)
    np.testing.assert_array_equal(t_lw, j_lw)


def test_effective_sample_sizes_match_jax():
    jsmc = _jsmc()
    n = 50
    assert tsmc.effective_sample_size(np.zeros(n)) == pytest.approx(n)
    degenerate = np.full(n, -np.inf)
    degenerate[0] = 0.0
    assert tsmc.effective_sample_size(degenerate) == pytest.approx(1.0)
    rng = np.random.default_rng(2)
    lw, inc = rng.normal(size=n), rng.normal(size=n)
    norm = lw - logsumexp(lw)
    assert abs(tsmc.effective_sample_size(lw) - jsmc.effective_sample_size(lw)) <= 1e-12 * n
    c_t = tsmc.conditional_effective_sample_size(norm, inc)
    assert abs(c_t - jsmc.conditional_effective_sample_size(norm, inc)) <= 1e-12 * n


def test_conditional_resample_threshold():
    idxs, _ = tsmc.conditional_multinomial_resample(np.zeros(40), thresh=0.5, rng=np.random.RandomState(0))
    np.testing.assert_array_equal(idxs, np.arange(40))  # high ESS: identity


# -- rmsd alignment ------------------------------------------------------------------------------


def _jrmsd():
    _jax()
    from timemachine_tpu.ops import rmsd as jrmsd

    return jrmsd


def test_align_x2_unto_x1_exact_recovery():
    rng = np.random.default_rng(4)
    x1 = rng.normal(size=(17, 3))
    theta = 1.1
    R = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0], [0, 0, 1.0]])
    x2 = x1 @ R.T + np.array([0.5, -1.0, 2.0])
    np.testing.assert_allclose(trmsd.align_x2_unto_x1(x1, x2).numpy(), x1, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alignment_matches_jax(seed):
    jrmsd = _jrmsd()
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(9, 3))
    x2 = rng.normal(size=(9, 3)) + 0.3 * x1
    cases = [(x1, x2)]
    if seed == 0:  # a mirror image: the best proper rotation needs the reflection flip
        cases.append((x1, x1 * np.array([-1.0, 1.0, 1.0]) + 0.2))
    for a, b in cases:
        np.testing.assert_allclose(trmsd.align_x2_unto_x1(a, b).numpy(), np.asarray(jrmsd.align_x2_unto_x1(a, b)),
                                   rtol=0, atol=ALIGN_TOL)
        for t, j in zip(trmsd.rmsd_align(a, b), jrmsd.rmsd_align(a, b)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ALIGN_TOL)
        R_t = trmsd.get_optimal_rotation(a - a.mean(0), b - b.mean(0)).numpy()
        assert np.linalg.det(R_t) == pytest.approx(1.0, abs=1e-12)
        conf = np.concatenate([a, b])
        idx_a, idx_b = np.arange(9), np.arange(9, 18)
        u_t = float(trmsd.rmsd_restraint(conf, None, None, idx_a, idx_b, k=10.0))
        u_j = float(jrmsd.rmsd_restraint(conf, None, None, idx_a, idx_b, k=10.0))
        assert abs(u_t - u_j) <= 1e-12 * max(abs(u_j), 1.0)


def test_rmsd_restraint_zero_when_aligned():
    x = np.random.default_rng(5).normal(size=(8, 3))
    conf = np.concatenate([x, x + 5.0])
    assert float(trmsd.rmsd_restraint(conf, None, None, np.arange(8), np.arange(8, 16), k=10.0)) == pytest.approx(
        0.0, abs=1e-8)


# -- protocol optimization ---------------------------------------------------------------------------


def _ladder():
    from timemachine_torch.fe.mbar import solve_mbar

    rng = np.random.default_rng(9)
    lambdas = np.linspace(0, 1, 8)
    sigmas = 1.0 - 0.7 * lambdas
    xs = np.concatenate([rng.normal(0, s, 400) for s in sigmas])
    u_kn = np.stack([0.5 * xs**2 / s**2 for s in sigmas])
    N_k = np.full(len(lambdas), 400)
    f_k, _ = solve_mbar(u_kn, N_k)
    return lambdas, u_kn, np.asarray(f_k), N_k


def test_greedy_protocol_gaussian_ladder_matches_jax():
    _jax()
    from timemachine_tpu.optimize import protocol as jprot

    lambdas, u_kn, f_k, N_k = _ladder()
    dist = tprot.make_fast_approx_overlap_distance_fxn(lambdas, u_kn, f_k, N_k)
    protocol = tprot.greedily_optimize_protocol(dist, target_distance=0.4)
    assert protocol[0] == 0.0 and protocol[-1] == 1.0 and np.all(np.diff(protocol) > 0)
    for a, b in zip(protocol[:-2], protocol[1:-1]):
        assert float(dist(a, b)) <= 0.45
    j_dist = jprot.make_fast_approx_overlap_distance_fxn(lambdas, u_kn, f_k, N_k)
    j_protocol = np.asarray(jprot.greedily_optimize_protocol(j_dist, target_distance=0.4))
    np.testing.assert_allclose(protocol, j_protocol, rtol=0, atol=1e-12)
    for a, b in ((0.0, 0.3), (0.25, 0.9), (0.5, 0.55)):
        assert abs(float(dist(a, b)) - float(j_dist(a, b))) <= 1e-12
    w_t = tprot.work_stddev_distance_fxn(lambdas, u_kn, f_k, N_k)
    w_j = jprot.work_stddev_distance_fxn(lambdas, u_kn, f_k, N_k)
    for a, b in ((0.0, 0.2), (0.3, 0.5), (0.1, 0.3)):
        assert abs(float(w_t(a, b)) - float(w_j(a, b))) <= 1e-12 * max(abs(float(w_j(a, b))), 1.0)
    assert w_t(0.1, 0.6) == np.inf  # beyond max_step
    u_inf = u_kn.copy()
    u_inf[3, :5] = np.inf
    interp_t = tprot.linear_u_kn_interpolant(lambdas, u_inf)
    interp_j = jprot.linear_u_kn_interpolant(lambdas, u_inf)
    for lam in (-0.1, 0.0, 0.37, 3 / 7, 0.5, 1.0, 1.2):
        a, b = interp_t(lam), np.asarray(interp_j(lam))
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=0)  # the last bit: XLA's and numpy's roundings


# -- enhanced sampling -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ethanol():
    """Both packages' ethanol at the RBFE cache's conformer, force fields and vacuum states."""
    _jax()
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.ff import Forcefield as JF
    from timemachine_tpu.md import enhanced as je

    conf = np.asarray(rbfe_solvent.metadata(rbfe_solvent.load_arrays())["conf_a"])
    j_mol = j_mol_from_smiles("CCO", add_hs=True, name="ethanol")
    t_mol = t_mol_from_smiles("CCO", add_hs=True, name="ethanol")
    for m in (j_mol, t_mol):
        m.set_conf(conf)
    jff, tff = JF.load_default(), TF.load_default()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_state = je.VacuumState(j_mol, jff)
    return dict(conf=conf, j_mol=j_mol, t_mol=t_mol, jff=jff, tff=tff, j_state=j_state,
                t_state=te.VacuumState(t_mol, tff, device=CPU))


def test_vacuum_state_energies_match_jax(ethanol):
    x0 = ethanol["conf"]
    for name in ("U_easy", "U_full", "U_decharged"):
        u_t = float(getattr(ethanol["t_state"], name)(x0))
        u_j = float(getattr(ethanol["j_state"], name)(x0))
        assert np.isfinite(u_t) and abs(u_t - u_j) <= ENERGY_REL * max(abs(u_j), 1.0), name
    assert float(ethanol["t_state"].U_easy(x0)) != float(ethanol["t_state"].U_full(x0))


def test_log_weights_for_given_conformers_match_jax(ethanol):
    jax = _jax()
    from timemachine_torch.constants import BOLTZ

    xs = ethanol["conf"][None, None] + np.random.default_rng(3).normal(0, 0.01, (3, 4, 9, 3))
    kT = 300.0 * BOLTZ
    t = te._log_weights(torch.as_tensor(xs), ethanol["t_state"].U_easy, ethanol["t_state"].U_full, kT)
    js = ethanol["j_state"]
    batch = lambda U: np.asarray(jax.vmap(jax.vmap(U))(xs))
    j = ((-batch(js.U_full) + batch(js.U_easy)) / kT).reshape(-1)
    np.testing.assert_allclose(t, j, rtol=0, atol=ENERGY_REL * np.abs(j).max())


def test_generate_log_weighted_samples(ethanol):
    state = ethanol["t_state"]
    xvs, log_weights = te.generate_log_weighted_samples(
        ethanol["t_mol"], 300.0, state.U_easy, state.U_full, seed=5, steps_per_batch=25, num_batches=48, num_workers=4,
        burn_in_batches=10, device=CPU,
    )
    assert xvs.shape == (48, 2, 9, 3) and np.isfinite(log_weights).all()
    assert 1.0 <= tsmc.effective_sample_size(log_weights) <= 48.0
    resampled = te.sample_from_log_weights(list(xvs), log_weights, size=16, rng=np.random.RandomState(1))
    assert len(resampled) == 16
    again = te.generate_log_weighted_samples(
        ethanol["t_mol"], 300.0, state.U_easy, state.U_full, seed=5, steps_per_batch=25, num_batches=48, num_workers=4,
        burn_in_batches=10, device=CPU,
    )
    np.testing.assert_array_equal(again[0], xvs)


def test_simulate_batch_steps_match_jax_given_the_same_noise(ethanol):
    jax = _jax()
    import jax.random as jr

    from timemachine_tpu.fe.utils import get_mol_masses
    from timemachine_tpu.md.enhanced import simulate_batch as j_simulate_batch
    from timemachine_torch.constants import BOLTZ

    x0 = ethanol["conf"]
    masses = np.asarray(get_mol_masses(ethanol["j_mol"]))
    W, S, B, seed, n = 3, 2, 2, 11, len(x0)
    j_xs, j_vs = j_simulate_batch(x0, ethanol["j_state"].U_full, 300.0, masses, S, B, W, seed)
    # JAX's draws, rebuilt: the start from the last of W + 1 keys, each walker's steps from its own
    keys = jr.split(jr.key(seed), W + 1)
    walker_keys, noise_key = keys[:-1], keys[-1]
    x_init = x0[None] + 0.01 * np.asarray(jr.normal(noise_key, (W, n, 3)))
    sigma = np.sqrt(BOLTZ * 300.0 / masses)
    v_init = sigma[None, :, None] * np.asarray(jr.normal(jr.fold_in(noise_key, 1), (W, n, 3)))
    noise = [
        np.stack([np.asarray(jr.normal(jr.split(jr.split(walker_keys[w], B)[b], S)[s], (n, 3))) for w in range(W)])
        for b in range(B) for s in range(S)
    ]
    draws = iter(noise)
    t_xs, t_vs = te._simulate(torch.as_tensor(x_init), torch.as_tensor(v_init), ethanol["t_state"].U_full, 300.0, masses,
                              1.5e-3, 1.0, S, B, lambda shape: torch.as_tensor(next(draws)))
    np.testing.assert_allclose(t_xs, np.asarray(j_xs), rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(t_vs, np.asarray(j_vs), rtol=0, atol=STEP_TOL)


def test_align_and_replace_matches_jax(ethanol):
    _jax()
    from timemachine_tpu.md import enhanced as je

    rng = np.random.default_rng(11)
    x_solvent = rng.normal(size=(9 + 30, 3))
    x_vacuum = ethanol["conf"]
    replaced = te.align_and_replace(x_vacuum, x_solvent).numpy()
    np.testing.assert_array_equal(replaced[:30], x_solvent[:30])
    d_new = np.linalg.norm(replaced[30:][:, None] - replaced[30:][None, :], axis=-1)
    d_old = np.linalg.norm(x_vacuum[:, None] - x_vacuum[None, :], axis=-1)
    np.testing.assert_allclose(d_new, d_old, atol=1e-6)
    np.testing.assert_allclose(replaced, np.asarray(je.align_and_replace(x_vacuum, x_solvent)), rtol=0, atol=ALIGN_TOL)
    batch = x_vacuum[None] + rng.normal(0, 0.05, (4, 9, 3))
    np.testing.assert_allclose(te.batch_align_and_replace(batch, x_solvent).numpy(),
                               np.asarray(je.batch_align_and_replace(batch, x_solvent)), rtol=0, atol=ALIGN_TOL)


def test_generate_endstate_samples_given_the_same_draws_is_jax_bitwise():
    _jax()
    from timemachine_tpu.fe import absolute_hydration as jah
    from timemachine_tpu.md.states import CoordsVelBox as JCVB
    from timemachine_torch.fe import absolute_hydration as tah

    rng = np.random.default_rng(8)
    solvent = [(rng.normal(size=(20, 3)), rng.normal(size=(20, 3)), np.eye(3) * (2 + i)) for i in range(5)]
    ligand_samples = rng.normal(size=(30, 2, 9, 3))
    log_weights = rng.normal(size=30)
    np.random.seed(123)
    j = jah.generate_endstate_samples(7, [JCVB(*s) for s in solvent], ligand_samples, log_weights, 9)
    t = tah.generate_endstate_samples(7, [CoordsVelBox(*s) for s in solvent], ligand_samples, log_weights, 9,
                                      rng=np.random.RandomState(123))
    assert len(t) == len(j) == 7
    for a, b in zip(t, j):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa, np.asarray(fb))


@pytest.mark.parametrize("lamb", [1.0, 0.3])
def test_solvent_phase_system_matches_jax(ethanol, lamb):
    from timemachine_tpu.md import enhanced as je

    j_pots, j_params, j_masses, j_coords, j_box = je.get_solvent_phase_system(
        ethanol["j_mol"], ethanol["jff"], lamb, minimize_energy=False)
    t_pots, t_params, t_masses, t_coords, t_box = te.get_solvent_phase_system(
        ethanol["t_mol"], ethanol["tff"], lamb, minimize_energy=False, device=CPU)
    assert [type(p).__name__ for p in t_pots] == [type(p).__name__ for p in j_pots]
    for jp, tp in zip(j_params, t_params):
        a, b = np.asarray(jp, np.float64), torch.as_tensor(tp).detach().numpy()
        assert a.shape == b.shape
        if a.size:
            scale = np.maximum(np.abs(a).reshape(len(a), -1).max(0), 1e-300)
            assert (np.abs(b - a).reshape(len(a), -1) / scale).max() <= 1e-12
    np.testing.assert_array_equal(t_masses, np.asarray(j_masses))
    np.testing.assert_array_equal(t_coords, np.asarray(j_coords))
    np.testing.assert_array_equal(t_box, np.asarray(j_box))


# -- the MD moves -------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solvent_system(ethanol):
    """The solvated ethanol at λ = 1 in a 2.0 + 0.5 nm box (unminimized: at λ = 1 the ligand
    does not interact), as the port's modules on the CPU."""
    pots, params, masses, coords, box = te.get_solvent_phase_system(
        ethanol["t_mol"], ethanol["tff"], 1.0, box_width=2.0, minimize_energy=False, device=CPU)
    return pots, params, masses, coords, box


def _chain(solvent_system, n_moves, n_steps):
    from timemachine_torch.md.moves import NPTMove

    pots, params, masses, coords, box = solvent_system
    mover = NPTMove(te.solvent_phase_modules(pots, params, len(masses), CPU), masses, 300.0, 1.0, n_steps=n_steps,
                    seed=2022)
    return mover, mover.sample_chain(CoordsVelBox(coords, np.zeros_like(coords), box), n_moves)


def test_npt_move_chain_is_bitwise_on_repeat_and_carries_its_step_count(solvent_system):
    mover, chain = _chain(solvent_system, 2, 3)
    _, again = _chain(solvent_system, 2, 3)
    for a, b in zip(chain, again):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa, fb)
    assert all(np.isfinite(s.coords).all() for s in chain)
    # 6 steps over two moves: the barostat (every 5) fired once, at global step 5
    assert mover._step_offset == 6 and mover._ctxt._step == 6
    baro_state = mover._ctxt.get_mover_states()[0]
    assert int(baro_state.total_attempted) == 1
    assert not np.array_equal(chain[1].box, chain[0].box) or int(baro_state.total_accepted) == 0
    # a window switch swaps parameters without a rebuild
    ctxt = mover._ctxt
    params = [p.copy() for p in ctxt.get_params()]
    params[5][:, 3] = 0.0  # the interaction group's w: coupled
    mover.set_params(params)
    assert mover._ctxt is ctxt
    np.testing.assert_array_equal(mover.bps[5].params.numpy(), params[5])
    moved = mover.move(chain[-1])
    assert np.isfinite(moved.coords).all() and mover._step_offset == 9
