"""The port's Barker proposal and equilibrate_host_barker
(timemachine_torch/md/barker.py, md/minimizer.py) against timemachine_tpu's,
in float64 on the CPU.

tests/test_analysis_tools.py's three Barker cases run on the port. Where
the port draws z and u from a torch.Generator and JAX splits a jax.random
key (ROADMAP P30), the port is fed JAX's draws (rebuilt here) and held to
JAX: the proposal bitwise's neighbour, BARKER_TOL; the log density to
1e-12; equilibrate_host_barker over a water box under 1,000 atoms, 20
steps, to HOST_TOL nm (both packages' host term is the dense exact form
below 4,096 atoms).
"""

import jax
import numpy as np
import pytest
import torch

from timemachine_torch.md import barker as tb
from timemachine_torch.md import minimizer as tm

torch.set_num_threads(1)  # the suite's workers share the host's cores

jax.config.update("jax_enable_x64", True)

CPU = torch.device("cpu")
BARKER_TOL = 1e-14
DENSITY_TOL = 1e-12
HOST_TOL = 1e-10  # nm
HOST_BOX, HOST_STEPS, HOST_SEED, HOST_FIRE_STEPS = 2.0, 20, 2024, 40


def _gen(seed):
    g = torch.Generator(device=CPU)
    g.manual_seed(seed)
    return g


def _jax_draws(key, n_steps, shape, sigma):
    """JAX's (z, u) of each step of barker_chain(key, ...)."""
    import jax.numpy as jnp
    import jax.random as jr

    out = []
    for k in jr.split(key, n_steps):
        k_z, k_b = jr.split(k)
        out.append((np.asarray(sigma * jr.normal(k_z, shape, dtype=jnp.float64)), np.asarray(jr.uniform(k_b, shape, dtype=jnp.float64))))
    return out


def test_barker_proposal_shapes_and_determinism():
    for shape in [(1,), (10,), (10, 3)]:
        x = torch.ones(shape, dtype=torch.float64)
        g = torch.ones(shape, dtype=torch.float64)
        y = tb.barker_propose(_gen(0), x, g, sigma=0.1)
        assert y.shape == shape
        assert tb.barker_log_density(x, y, g, sigma=0.1).ndim == 0
        assert torch.equal(y, tb.barker_propose(_gen(0), x, g, sigma=0.1))


@pytest.mark.parametrize("x0", [-1.0, 0.0, 1.0])
@pytest.mark.parametrize("sigma", [0.1, 1.0])
def test_barker_proposal_normalization(x0, sigma):
    r"""\int dy p_sigma(y | x0) == 1 for a quartic target; the density
    equals JAX's on the grid."""
    from timemachine_tpu.md.barker import barker_log_density as j_density

    g0 = -4.0 * x0**3
    y_grid = np.linspace(x0 - 10 * sigma, x0 + 10 * sigma, 4001)
    logpdf = np.array([float(tb.barker_log_density(np.array([x0]), np.array([y]), np.array([g0]), sigma)) for y in y_grid])
    assert np.trapezoid(np.exp(logpdf), y_grid) == pytest.approx(1.0, abs=1e-3)
    for y in y_grid[::400]:
        ref = float(j_density(np.array([x0]), np.array([y]), np.array([g0]), sigma))
        t = float(tb.barker_log_density(np.array([x0]), np.array([y]), np.array([g0]), sigma))
        assert t == pytest.approx(ref, rel=DENSITY_TOL, abs=DENSITY_TOL)


def test_barker_chain_equilibrates_gaussian():
    mu = 3.0
    x0 = torch.full((2000,), -5.0, dtype=torch.float64)
    xs = tb.barker_chain(_gen(3), x0, lambda x: -(x - mu), sigma=0.25, n_steps=800).numpy()
    assert abs(xs.mean() - mu) < 0.15
    assert abs(xs.std() - 1.0) < 0.15


def test_barker_chain_matches_jax_given_its_draws():
    """The port's step on JAX's z and u is JAX's chain, step by step."""
    import jax.random as jr
    from timemachine_tpu.md.barker import barker_chain as j_chain

    mu, sigma, n = 1.5, 0.3, 10
    x0 = np.random.default_rng(0).normal(0, 2, (50, 3))
    key = jr.key(7)
    ref = np.asarray(j_chain(key, x0, lambda x: -(x - mu) ** 3, sigma, n))
    x = torch.as_tensor(x0)
    for z, u in _jax_draws(key, n, x0.shape, sigma):
        x = tb.barker_step(x, -(x - mu) ** 3, torch.tensor(z), torch.tensor(u))
    np.testing.assert_allclose(x.numpy(), ref, rtol=0, atol=BARKER_TOL)


def test_barker_chain_replays_from_its_seed():
    """A generator seeded alike gives the chain's draws: the card check's replay."""
    x0 = torch.as_tensor(np.random.default_rng(1).normal(0, 1, (30, 3)))
    grad = lambda x: -x  # noqa: E731
    out = tb.barker_chain(_gen(5), x0, grad, 0.2, 7)
    g, x = _gen(5), x0
    for _ in range(7):
        z, u = tb.barker_draws(g, x, 0.2)
        x = tb.barker_step(x, grad(x), z, u)
    assert torch.equal(out, x)


@pytest.fixture(scope="module")
def water_host():
    """Ethanol (the RBFE cache's conformer) in build_water_system(2.0) of
    both packages, the host relaxed by the port's FIRE."""
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.ff import Forcefield as JF
    from timemachine_tpu.md.builders import build_water_system as j_build

    from timemachine_torch.chem import mol_from_smiles as t_mol_from_smiles
    from timemachine_torch.ff import Forcefield as TF
    from timemachine_torch.md.builders import build_water_system as t_build
    from timemachine_torch.testsystems import rbfe_solvent

    conf = rbfe_solvent.metadata(rbfe_solvent.load_arrays())["conf_a"]
    j_mol, t_mol = j_mol_from_smiles("CCO", add_hs=True, name="ethanol"), t_mol_from_smiles("CCO", add_hs=True, name="ethanol")
    for m in (j_mol, t_mol):
        m.set_conf(np.asarray(conf))
    jff, tff = JF.load_default(), TF.load_default()
    j_host = j_build(HOST_BOX, jff.water_ff, mols=[j_mol])
    t_host = t_build(HOST_BOX, tff.water_ff, mols=[t_mol])
    assert len(t_host.conf) < 1000
    np.testing.assert_array_equal(t_host.conf, j_host.conf)
    # a short FIRE descent first, so that the host passes the force check
    # after 20 Barker steps (from the raw box it takes hundreds)
    relaxed = tm.fire_minimize_host([t_mol], t_host, tff, n_steps_per_window=HOST_FIRE_STEPS, device=CPU)
    t_host.conf = j_host.conf = relaxed
    return dict(j_mol=j_mol, t_mol=t_mol, jff=jff, tff=tff, j_host=j_host, t_host=t_host)


def test_equilibrate_host_barker_matches_jax_given_its_draws(water_host, monkeypatch):
    import jax.random as jr
    from timemachine_tpu.md import minimizer as jm

    e = water_host
    ref = jm.equilibrate_host_barker([e["j_mol"]], e["j_host"], e["jff"], n_steps=HOST_STEPS, seed=HOST_SEED)
    draws = iter(_jax_draws(jr.key(HOST_SEED), HOST_STEPS, e["t_host"].conf.shape, 1e-4))

    def jax_draws(generator, x, sigma):
        z, u = next(draws)
        return torch.tensor(z), torch.tensor(u)

    monkeypatch.setattr(tb, "barker_draws", jax_draws)
    out = tm.equilibrate_host_barker([e["t_mol"]], e["t_host"], e["tff"], n_steps=HOST_STEPS, seed=HOST_SEED, device=CPU)
    assert out.shape == e["t_host"].conf.shape and np.isfinite(out).all()
    assert np.abs(out - e["t_host"].conf).max() > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=HOST_TOL)


def test_equilibrate_host_barker_is_its_chain_and_repeats(water_host):
    """From its seed the result is barker_chain over make_host_du_dx_fxn,
    bitwise, and a rerun is bitwise; a proposal stddev over 1e-4 nm is refused."""
    from timemachine_torch.constants import BOLTZ

    e = water_host
    args = ([e["t_mol"]], e["t_host"], e["tff"])
    out = tm.equilibrate_host_barker(*args, n_steps=5, seed=11, device=CPU)
    np.testing.assert_array_equal(out, tm.equilibrate_host_barker(*args, n_steps=5, seed=11, device=CPU))
    du_dx = tm.make_host_du_dx_fxn(*args, device=CPU)
    kT = BOLTZ * 300.0
    x = tb.barker_chain(_gen(11), torch.as_tensor(e["t_host"].conf), lambda x: -du_dx(x) / kT, 1e-4, 5)
    np.testing.assert_array_equal(out, x.numpy())
    with pytest.raises(ValueError):
        tm.equilibrate_host_barker(*args, proposal_stddev=1e-3, device=CPU)
