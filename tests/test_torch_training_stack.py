"""The port's MLE over an edge graph, targeted-FEP maps, local geometry,
best-first search and local resampling (timemachine_torch/fe/mle.py,
maps/, fe/geometry.py, fe/tree_search.py, md/local_resampling.py) against
timemachine_tpu's, in float64 on the CPU, on inputs made from a numpy seed:
the cases of tests/test_training_stack.py on both packages.

Tolerances: node values and bootstrap errors to TOL (both numpy, the same
draws); the terminal-bond maps and their log-Jacobians to TOL, the
log-Jacobian also against torch.func's Jacobian; local resampling's mask
bitwise from the same numpy Generator, the move and its log densities to
TOL. The networkx front end reads the graph by duck typing (ROADMAP P34)
and is fed a real networkx.DiGraph here.
"""

import jax
import networkx as nx
import numpy as np
import pytest
import torch

from timemachine_torch.fe import mle as tmle

torch.set_num_threads(1)  # the suite's workers share the host's cores

jax.config.update("jax_enable_x64", True)

CPU = torch.device("cpu")
TOL = 1e-12


# -- fe/mle -------------------------------------------------------------------------------------


def _edge_case(seed=0):
    rng = np.random.default_rng(seed)
    truth = np.array([0.0, 2.0, -1.0, 5.0, 3.0])
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 0], [1, 3]])
    stddevs = rng.uniform(0.1, 0.3, len(edges))
    diffs = truth[edges[:, 1]] - truth[edges[:, 0]] + rng.normal(0, 0.2, len(edges))
    return truth, edges, diffs, stddevs


@pytest.mark.parametrize("refs", [((), (), ()), ((1, 3), (2.1, 4.8), (0.1, 0.3))], ids=["no-refs", "two-refs"])
def test_mle_matches_jax_and_recovers_truth(refs):
    from timemachine_tpu.fe import mle as jmle

    truth, edges, diffs, stddevs = _edge_case()
    dg, err = tmle.infer_node_vals_and_errs(edges, diffs, stddevs, *refs, n_bootstrap=50, seed=1)
    dg_j, err_j = jmle.infer_node_vals_and_errs(edges, diffs, stddevs, *refs, n_bootstrap=50, seed=1)
    np.testing.assert_allclose(dg, dg_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(err, err_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(dg - dg[0], truth - truth[0], atol=0.5)
    point = tmle.infer_node_vals(edges, diffs, stddevs, *refs[:2])
    np.testing.assert_allclose(point, jmle.infer_node_vals(edges, diffs, stddevs, *refs[:2]), rtol=0, atol=TOL)
    np.testing.assert_allclose(point, dg, rtol=0, atol=TOL)
    if not refs[0]:
        assert np.all(err[1:] > 0) and err[0] == pytest.approx(0.0, abs=1e-10)


@pytest.mark.parametrize("edges", [[[0, 1], [2, 3]], [[0, 2], [2, 3]]], ids=["disconnected", "missing-node"])
def test_mle_rejects_bad_graphs(edges):
    with pytest.raises(ValueError):
        tmle.infer_node_vals(np.array(edges), np.zeros(2), np.ones(2))


def _nx_graph():
    g = nx.DiGraph()
    truth = {"a": 0.0, "b": 1.5, "c": -0.5, "d": 2.0}
    rng = np.random.default_rng(5)
    for u, v in [("a", "b"), ("b", "c"), ("a", "c"), ("c", "d"), ("b", "d")]:
        g.add_edge(u, v, pred=truth[v] - truth[u] + rng.normal(0, 0.05), err=rng.uniform(0.05, 0.2))
    g.add_edge("d", "a", pred=None, err=0.1)  # no prediction: left out
    g.add_edge("a", "d", pred=9.0, err=0.1, skip_for_mle=True)
    g.add_edge("x", "y", pred=1.0, err=0.1)  # a smaller component
    g.nodes["a"]["exp_dg"] = 0.0
    g.nodes["c"]["exp_dg"] = -0.4
    g.nodes["c"]["exp_dg_err"] = 0.1
    return g, truth


def test_mle_networkx_front_end_matches_jax():
    from timemachine_tpu.fe import mle as jmle

    g, truth = _nx_graph()
    out = tmle.infer_node_vals_and_errs_networkx(g, "pred", "err", "exp_dg", "exp_dg_err", n_bootstrap=20, seed=2)
    ref = jmle.infer_node_vals_and_errs_networkx(g, "pred", "err", "exp_dg", "exp_dg_err", n_bootstrap=20, seed=2)
    assert type(out) is nx.DiGraph
    assert sorted(out.nodes) == sorted(ref.nodes) == ["a", "b", "c", "d"]
    assert sorted(out.edges) == sorted(ref.edges)
    for n in ref.nodes:
        for prop in ("inferred_dg", "inferred_dg_stddev"):
            assert out.nodes[n][prop] == pytest.approx(ref.nodes[n][prop], abs=TOL)
        assert out.nodes[n]["inferred_dg"] == pytest.approx(truth[n], abs=0.3)
    assert out.nodes["c"]["exp_dg_err"] == 0.1  # node data carried
    with pytest.raises(TypeError):
        tmle.infer_node_vals_and_errs_networkx(g.to_undirected(), "pred", "err", "exp_dg", "exp_dg_err")
    with pytest.raises(ValueError):
        tmle.infer_node_vals_and_errs_networkx(g, "missing", "err", "exp_dg", "exp_dg_err")


# -- maps -----------------------------------------------------------------------------------------


def _terminal_states(pkg):
    bond_idxs = np.array([[0, 1], [1, 2], [1, 3]])
    src = pkg.TerminalMappableState.from_harmonic_bond_params(bond_idxs, np.array([[1e6, 0.10], [1e6, 0.11], [3e5, 0.15]]))
    dst = pkg.TerminalMappableState.from_harmonic_bond_params(bond_idxs, np.array([[2e6, 0.12], [1e6, 0.11], [4e5, 0.14]]))
    return src, dst


def _frames():
    base = np.array([[0.0, 0, 0], [0.10, 0, 0], [0.10, 0.11, 0], [0.2, -0.05, 0.08]])
    return base + np.random.default_rng(7).normal(0, 5e-4, (6, 4, 3))


def test_terminal_bond_map_matches_jax_and_round_trips():
    from timemachine_tpu.maps import terminal_bonds as jtb

    from timemachine_torch.maps import terminal_bonds as ttb

    assert ttb.find_terminal_bonds([[0, 1], [1, 2], [1, 3]]).tolist() == jtb.find_terminal_bonds([[0, 1], [1, 2], [1, 3]]).tolist()
    t_src, t_dst = _terminal_states(ttb)
    j_src, j_dst = _terminal_states(jtb)
    for t, j in ((t_src, j_src), (t_dst, j_dst)):
        np.testing.assert_array_equal(t.idxs, j.idxs)
        np.testing.assert_array_equal(t.window_lo, j.window_lo)
        np.testing.assert_array_equal(t.window_hi, j.window_hi)
    xs = _frames()
    fwd = ttb.TerminalBondMap.from_states(t_src, t_dst, device=CPU)
    rev = ttb.TerminalBondMap.from_states(t_dst, t_src, device=CPU)
    mapped, ldj = fwd(xs)
    mapped_j, ldj_j = jtb.TerminalBondMap.from_states(j_src, j_dst)(xs)
    np.testing.assert_allclose(mapped.numpy(), np.asarray(mapped_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(ldj.numpy(), np.asarray(ldj_j), rtol=0, atol=TOL)
    back, ldj_rev = rev(mapped)
    np.testing.assert_allclose(back.numpy(), xs, rtol=0, atol=1e-10)
    np.testing.assert_allclose((ldj + ldj_rev).numpy(), 0.0, atol=1e-10)
    assert t_src.contains_in_support(xs[0]) and t_dst.contains_in_support(mapped[0].numpy())
    # identical states: the identity
    same, zero = ttb.TerminalBondMap.from_states(t_src, t_src, device=CPU)(xs)
    np.testing.assert_array_equal(same.numpy(), xs)
    np.testing.assert_array_equal(zero.numpy(), 0.0)


def test_terminal_bond_map_log_jacobian_is_autograds():
    """The analytic log|det J| against slogdet of torch.func.jacfwd of the
    map on each frame's 12 coordinates."""
    from timemachine_torch.maps import terminal_bonds as ttb

    src, dst = _terminal_states(ttb)
    fmap = ttb.TerminalBondMap.from_states(src, dst, device=CPU)
    xs = torch.as_tensor(_frames()[:3])
    _, ldj = fmap(xs)
    for x, ref in zip(xs, ldj):
        jac = torch.func.jacfwd(lambda y: fmap(y.reshape(1, 4, 3))[0].reshape(-1))(x.reshape(-1))
        sign, logdet = torch.linalg.slogdet(jac)
        assert float(sign) == 1.0 and float(logdet) == pytest.approx(float(ref), abs=1e-10)


def test_thermal_window_refuses_nonpositive_lengths():
    from timemachine_torch.maps.terminal_bonds import thermal_length_window

    with pytest.raises(ValueError):
        thermal_length_window(np.array([10.0]), np.array([0.1]), 300.0)


def test_mapped_u_kn_and_work_match_jax():
    from timemachine_tpu.maps import estimators as jest

    from timemachine_torch.maps import estimators as test_

    rng = np.random.default_rng(3)
    samples = [rng.normal(size=(6, 2)), rng.normal(size=(5, 2))]
    fns = [lambda xs: (np.asarray(xs) ** 2).sum(1), lambda xs: 2 * (np.asarray(xs) ** 2).sum(1)]
    shift = lambda xs: (np.asarray(xs) + 0.1, np.full(len(xs), 0.3))  # noqa: E731
    ident = lambda xs: (xs, np.zeros(len(xs)))  # noqa: E731
    maps = {(i, j): (ident if i == j else shift) for i in range(2) for j in range(2)}
    u_kn = test_.compute_mapped_u_kn(samples, fns, maps)
    assert u_kn.shape == (2, 11)
    np.testing.assert_array_equal(u_kn, jest.compute_mapped_u_kn(samples, fns, maps))
    torch_fns = [lambda xs, f=f: torch.as_tensor(f(xs)) for f in fns]  # energies may be tensors
    np.testing.assert_array_equal(test_.mapped_u_kn(samples, torch_fns, maps), u_kn)
    w = test_.mapped_work(samples[0], fns[0], fns[1], shift)
    np.testing.assert_array_equal(w, jest.mapped_work(samples[0], fns[0], fns[1], shift))
    with pytest.raises(ValueError):
        test_.mapped_u_kn(samples, fns[:1], maps)


# -- fe/geometry and fe/tree_search -------------------------------------------------------------


@pytest.mark.parametrize("smiles", ["CC#N", "c1ccccc1", "CC(=O)O", "C=C=C", "CN(C)C", "CCO"])
def test_classify_geometry_matches_jax(smiles):
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.fe.geometry import classify_geometry as j_classify

    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.fe.geometry import LocalGeometry, classify_geometry

    for add_hs in (False, True):
        t = classify_geometry(mol_from_smiles(smiles, add_hs=add_hs))
        j = j_classify(j_mol_from_smiles(smiles, add_hs=add_hs))
        assert [g.name for g in t] == [g.name for g in j]
    if smiles == "CC#N":
        assert classify_geometry(mol_from_smiles(smiles)) == [
            LocalGeometry.G1_TERMINAL, LocalGeometry.G2_LINEAR, LocalGeometry.G1_TERMINAL,
        ]
    if smiles == "c1ccccc1":
        assert all(g == LocalGeometry.G2_KINK for g in classify_geometry(mol_from_smiles(smiles)))


@pytest.mark.parametrize("keyed", [False, True])
def test_best_first_matches_jax(keyed):
    from timemachine_tpu.fe.tree_search import best_first as j_best_first

    from timemachine_torch.fe.tree_search import best_first

    def expand(node, state):
        # children of n: 2n+1, 2n+2 under 40, the state counts expansions
        return [c for c in (2 * node + 1, 2 * node + 2) if c < 40], state + 1

    key = (lambda n: (n % 7, -n)) if keyed else None
    t = list(best_first(expand, 0, 0, key=key))
    assert t == list(j_best_first(expand, 0, 0, key=key))
    assert sorted(t) == list(range(40))


# -- md/local_resampling ---------------------------------------------------------------------------


def _lr_fns(lib):
    def target_logpdf(x):
        return -0.5 * (x**2).sum() - 0.1 * (x**4).sum()

    def selection_log_prob(x):
        # state dependent: particles far from the origin are more likely picked
        r2 = (x**2).sum(1)
        return lib.log(r2 / (1.0 + r2))

    def move(x_sub, logpdf):
        return 0.5 * x_sub, logpdf(x_sub)

    return target_logpdf, selection_log_prob, move


def test_local_resampling_matches_jax_given_one_numpy_generator():
    import jax.numpy as jnp
    from timemachine_tpu.md import local_resampling as jlr

    from timemachine_torch.md import local_resampling as tlr

    x0 = np.random.default_rng(4).normal(size=(30, 3))
    x_t, aux_t = tlr.local_resampling_move(x0, *_lr_fns(torch), rng=np.random.default_rng(9), device=CPU)
    x_j, aux_j = jlr.local_resampling_move(x0, *_lr_fns(jnp), rng=np.random.default_rng(9))
    moved_t, moved_j = np.any(x_t.numpy() != x0, axis=1), np.any(np.asarray(x_j) != x0, axis=1)
    np.testing.assert_array_equal(moved_t, moved_j)  # the mask, bitwise
    assert 0 < moved_t.sum() < 30
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=TOL)
    assert float(aux_t) == pytest.approx(float(aux_j), rel=TOL)
    mask = torch.as_tensor(moved_t)
    log_p = _lr_fns(torch)[1](torch.as_tensor(x0))
    assert float(tlr.bernoulli_logpdf(log_p, mask)) == pytest.approx(
        float(jlr.bernoulli_logpdf(np.asarray(log_p), moved_t)), rel=TOL)


def test_local_resampling_with_numpys_global_stream_matches_jax():
    import jax.numpy as jnp
    from timemachine_tpu.md import local_resampling as jlr

    from timemachine_torch.md import local_resampling as tlr

    x0 = np.random.default_rng(6).normal(size=(20, 3))
    np.random.seed(12)
    x_t, _ = tlr.local_resampling_move(x0, *_lr_fns(torch), device=CPU)
    np.random.seed(12)
    x_j, _ = jlr.local_resampling_move(x0, *_lr_fns(jnp))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=TOL)


def test_local_resampling_move_gaussian():
    """Exactness: local resampling of iid Gaussians keeps the marginals."""
    from timemachine_torch.md.local_resampling import local_resampling_move

    rng = np.random.default_rng(4)

    def target_logpdf(x):
        return -0.5 * torch.sum(x**2)

    def selection_log_prob(x):
        return torch.full((len(x),), float(np.log(0.5)), dtype=x.dtype)

    def mcmc_move(x_sub, logpdf):
        return torch.as_tensor(rng.normal(size=tuple(x_sub.shape))), None

    x = torch.as_tensor(rng.normal(size=(50, 3)))
    samples = []
    mask_rng = np.random.default_rng(5)
    for _ in range(200):
        x, _ = local_resampling_move(x, target_logpdf, selection_log_prob, mcmc_move, rng=mask_rng, device=CPU)
        samples.append(x.numpy())
    pooled = np.concatenate(samples).ravel()
    assert np.mean(pooled) == pytest.approx(0.0, abs=0.05)
    assert np.std(pooled) == pytest.approx(1.0, abs=0.05)


# -- md/thermostat -----------------------------------------------------------------------------------


def _thermostat_case():
    import timemachine_tpu.potentials as jp

    rng = np.random.default_rng(8)
    n = 6
    bonds = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5]], dtype=np.int32)
    bp = jp.HarmonicBond(bonds).bind(np.stack([np.full(5, 4e4), rng.uniform(0.12, 0.16, 5)], 1))
    x0 = np.cumsum(np.full((n, 3), 0.08) + rng.normal(0, 0.01, (n, 3)), axis=0)
    v0 = rng.normal(0, 0.5, (n, 3))
    return bp, x0, v0, np.eye(3) * 3.0, rng.uniform(1.0, 16.0, n)


def test_unadjusted_langevin_move_matches_jax_at_zero_temperature():
    """At 0 K the move is deterministic: two moves of 5 steps from one
    Context reset to each state equal JAX's to TOL (nm, nm/ps)."""
    from timemachine_tpu.integrators import LangevinIntegrator as JLangevin
    from timemachine_tpu.md.states import CoordsVelBox as JState
    from timemachine_tpu.md.thermostat.moves import UnadjustedLangevinMove as JMove

    from timemachine_torch.convert import modules_from_bound_potentials
    from timemachine_torch.integrators import LangevinIntegrator
    from timemachine_torch.md.states import CoordsVelBox
    from timemachine_torch.md.thermostat.moves import UnadjustedLangevinMove

    bp, x0, v0, box, masses = _thermostat_case()
    t_move = UnadjustedLangevinMove(LangevinIntegrator(0.0, 1.5e-3, 1.0, masses, 3),
                                    modules_from_bound_potentials([bp], len(x0), torch.device("cpu")), n_steps=5)
    j_move = JMove(JLangevin(0.0, 1.5e-3, 1.0, masses, 3), [bp], n_steps=5)
    t_state, j_state = CoordsVelBox(x0, v0, box), JState(x0, v0, box)
    for _ in range(2):
        t_state, j_state = t_move.move(t_state), j_move.move(j_state)
        np.testing.assert_allclose(t_state.coords, np.asarray(j_state.coords), rtol=0, atol=TOL)
        np.testing.assert_allclose(t_state.velocities, np.asarray(j_state.velocities), rtol=0, atol=TOL)
        np.testing.assert_array_equal(t_state.box, box)
    assert not np.allclose(t_state.coords, x0)


def test_unadjusted_langevin_move_repeats_and_keeps_its_context():
    from timemachine_torch.convert import modules_from_bound_potentials
    from timemachine_torch.integrators import LangevinIntegrator
    from timemachine_torch.md.states import CoordsVelBox
    from timemachine_torch.md.thermostat.moves import UnadjustedLangevinMove
    from timemachine_torch.md.thermostat.utils import sample_velocities

    bp, x0, _, box, masses = _thermostat_case()

    def chain():
        move = UnadjustedLangevinMove(LangevinIntegrator(300.0, 1.5e-3, 1.0, masses, 4),
                                      modules_from_bound_potentials([bp], len(x0), torch.device("cpu")), n_steps=4)
        states = move.sample_chain(CoordsVelBox(x0, sample_velocities(masses, 300.0, 1), box), 3)
        return move, states

    move, states = chain()
    context = move._ctxt
    move.move(states[-1])
    assert move._ctxt is context  # built once, reset for each state
    _, again = chain()
    for a, b in zip(states, again):
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.velocities, b.velocities)
    assert np.isfinite(states[-1].coords).all() and not np.array_equal(states[0].coords, states[1].coords)
