"""MBAR and BAR of the port (timemachine_torch/fe/mbar.py, fe/bar.py) and
the pair-BAR estimate of fe/free_energy.py against timemachine_tpu, on
reduced energies made from a seed with numpy.

Tolerances: every estimate, error and overlap to 1e-8 (both solve the same
fixed point in f64 with the same stopping rule, so they stop at the same
iterate); the MBAR implicit gradient to 1e-6 of its largest entry.
"""

import jax
import numpy as np
import pytest
import torch

from timemachine_torch.fe import bar as tbar
from timemachine_torch.fe import free_energy as tfe
from timemachine_torch.fe import mbar as tmbar

torch.set_num_threads(1)  # the suite's workers share the host's cores

jax.config.update("jax_enable_x64", True)






def _ukln_case(seed, n=40, shift=1.5):
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 1, (2, 2, n))
    u[0, 1] += shift + rng.normal(0, 0.7, n)
    u[1, 0] += -shift + 2.0 + rng.normal(0, 0.7, n)
    return u


def test_mbar_matches_jax():
    """MBAR on three states (u_kn from a seed): f_k, the uncertainties and
    the overlap matrix against the JAX solver to 1e-8."""
    import jax.numpy as jnp

    from timemachine_tpu.fe import mbar as jmbar

    rng = np.random.default_rng(3)
    u_kn = rng.normal(0, 1, (3, 90)) + np.array([[0.0], [0.7], [1.9]]) * rng.uniform(0.5, 1.5, 90)
    n_k = np.array([30, 30, 30])
    m, j = tmbar.MBAR(u_kn, n_k), jmbar.MBAR(jnp.asarray(u_kn), n_k)
    np.testing.assert_allclose(m.f_k, j.f_k, rtol=0, atol=1e-8)
    for key in ("Delta_f", "dDelta_f"):
        np.testing.assert_allclose(
            m.compute_free_energy_differences()[key], j.compute_free_energy_differences()[key], rtol=0, atol=1e-8
        )
    np.testing.assert_allclose(m.compute_overlap()["matrix"], j.compute_overlap()["matrix"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tmbar.kln_to_kn(u_kn.reshape(3, 3, 30)), jmbar.kln_to_kn(u_kn.reshape(3, 3, 30)))
    assert float(tmbar.exp_estimator(u_kn[0])) == pytest.approx(float(jmbar.exp_estimator(u_kn[0])), abs=1e-10)


def test_mbar_drops_samples_of_no_measure():
    """A sample with u = +inf in every state has no weight: f_k, the
    weights and the uncertainties equal the JAX solver's to 1e-8, and the
    sample's weights are zero."""
    import jax.numpy as jnp

    from timemachine_tpu.fe import mbar as jmbar

    u_kn = np.random.default_rng(7).normal(0, 1, (2, 40)) + np.array([[0.0], [1.0]])
    u_kn[:, 5] = np.inf
    m, j = tmbar.MBAR(u_kn, [20, 20]), jmbar.MBAR(jnp.asarray(u_kn), np.array([20, 20]))
    np.testing.assert_allclose(m.f_k, j.f_k, rtol=0, atol=1e-8)
    np.testing.assert_allclose(m.weights, j.weights, rtol=0, atol=1e-8)
    assert not m.weights[5].any()


def test_mbar_implicit_gradient_matches_jax():
    """d(w . f_k)/d(u_kn) through the implicit-derivative backward against
    jax.grad of the JAX solver's custom VJP: 1e-6 of the largest entry."""
    import jax.numpy as jnp

    from timemachine_tpu.fe import mbar as jmbar

    rng = np.random.default_rng(4)
    u_kn = rng.normal(0, 1, (3, 60)) + np.array([[0.0], [0.5], [1.2]])
    n_k = np.array([20.0, 20.0, 20.0])
    w = np.array([0.3, -1.0, 2.0])
    u = torch.tensor(u_kn, requires_grad=True)
    f_k, _ = tmbar.solve_mbar(u, torch.tensor(n_k))
    (g,) = torch.autograd.grad(torch.sum(torch.tensor(w) * f_k), u)
    g_j = jax.grad(lambda uu: jnp.sum(jnp.asarray(w) * jmbar.solve_mbar(uu, n_k)[0]))(jnp.asarray(u_kn))
    assert np.abs(g.numpy() - np.asarray(g_j)).max() <= 1e-6 * np.abs(np.asarray(g_j)).max()


@pytest.mark.parametrize("spread", [1.0, 4.0])
def test_batched_solve_equals_solves_alone(spread):
    """solve_mbar on a batch of 30 frame-resampled pair problems (as
    bootstrap_bar solves them, warm-started) against each problem solved
    alone: the same iteration counts and f_k to 1e-12. Both works are
    raised by `spread`: at 4 the states overlap so little that some
    problems stop at the iteration limit while others converge."""
    rng = np.random.default_rng(8)
    u_kln = _ukln_case(9, n=6)
    u_kln[0, 1] += spread
    u_kln[1, 0] += spread
    u_bkn = np.stack([tbar.ukln_to_ukn(u_kln[:, :, rng.integers(0, 6, size=6)])[0] for _ in range(30)])
    f0 = np.array([0.0, 0.5 * spread])
    f_b, its_b = tmbar.solve_mbar(u_bkn, [6, 6], initial_f_k=f0, maximum_iterations=300)
    alone = [tmbar.solve_mbar(u, [6, 6], initial_f_k=f0, maximum_iterations=300) for u in u_bkn]
    assert its_b.tolist() == [int(it) for _, it in alone]
    np.testing.assert_allclose(f_b.numpy(), np.stack([f.numpy() for f, _ in alone]), rtol=0, atol=1e-12)
    if spread > 1.0:
        assert int(its_b.min()) < 300 == int(its_b.max())


BAR_FNS = {
    "df_and_err_from_u_kln": lambda m, u: m.df_and_err_from_u_kln(u),
    "bar_with_pessimistic_uncertainty": lambda m, u: m.bar_with_pessimistic_uncertainty(u),
    "bootstrap_bar": lambda m, u: m.bootstrap_bar(u),
    "pair_overlap_from_ukln": lambda m, u: m.pair_overlap_from_ukln(u),
    "bar": lambda m, u: m.bar(*m.works_from_ukln(u)),
    "EXP": lambda m, u: m.EXP(m.works_from_ukln(u)[0]),
    "dG_dw": lambda m, u: m.dG_dw(np.stack(m.works_from_ukln(u))),
    "df_from_ukln_by_lambda": lambda m, u: m.df_from_ukln_by_lambda(np.stack([u, u[::-1, ::-1]])),
    "compute_fwd_and_reverse_df_over_time": lambda m, u: m.compute_fwd_and_reverse_df_over_time(np.stack([u, u]), 10),
}


def _flat(v):
    return np.hstack([np.ravel(np.asarray(x, dtype=np.float64)) for x in (v if isinstance(v, tuple) else (v,))])


@pytest.mark.parametrize("fn", list(BAR_FNS))
def test_bar_matches_jax(fn):
    """Each estimator of fe/bar.py on the same u_kln (40 frames from a seed)
    against the JAX package's: every number to 1e-8."""
    from timemachine_tpu.fe import bar as jbar

    u = _ukln_case(5)
    np.testing.assert_allclose(_flat(BAR_FNS[fn](tbar, u)), _flat(BAR_FNS[fn](jbar, u)), rtol=0, atol=1e-8)


def test_estimate_free_energy_bar_matches_jax():
    """estimate_free_energy_bar on an eight-component u_kln (one component
    with works exactly zero, as the host term's are, one with a NaN)
    against JAX's BarResult: dG, dG_err, the per-component errors and
    overlaps, to 1e-8; the zero-work component's error is 0."""
    from timemachine_tpu.fe import free_energy as jfe

    rng = np.random.default_rng(6)
    comps = np.stack([_ukln_case(10 + k, n=20, shift=0.3 * k) for k in range(8)])
    comps[6] = rng.normal(0, 1, (1, 1, 20)).repeat(2, 0).repeat(2, 1)  # u_k0 = u_k1: zero works
    comps[2, 1, 0, 3] = np.nan
    with pytest.warns(tfe.IndeterminateEnergyWarning):
        res = tfe.estimate_free_energy_bar(comps, 300.0)
    with pytest.warns(UserWarning):
        j_res = jfe.estimate_free_energy_bar(comps, 300.0)
    assert res.dG_err_by_component[6] == 0.0
    for field in ("dG", "dG_err", "dG_err_by_component", "overlap", "overlap_by_component"):
        np.testing.assert_allclose(getattr(res, field), getattr(j_res, field), rtol=0, atol=1e-8, err_msg=field)
