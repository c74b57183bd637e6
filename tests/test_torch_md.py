"""timemachine_torch MD pieces against timemachine_tpu: the Langevin step
with injected noise, the barostat move fed the uniforms JAX draws, FIRE, and
the Context over 40 steps across a list rebuild.

JAX's threefry noise cannot be reproduced in torch, so the step takes
injected noise and the Context comparison runs at T = 0, where the noise
term's coefficient is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch import integrators as tint
from timemachine_torch.convert import host_config_from_jax
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.context import Context
from timemachine_torch.md.fire import FireMinimizationConfig, fire_minimize
from timemachine_tpu import integrators as jint
from timemachine_tpu.md import barostat as jbaro
from timemachine_tpu.md.builders import build_water_system
from timemachine_tpu.md.context import Context as JaxContext
from timemachine_tpu.md.fire import FireMinimizationConfig as JaxFireConfig
from timemachine_tpu.md.fire import fire_minimize_jax
from timemachine_tpu.md.utils import sample_velocities

torch.set_num_threads(1)  # the suite's workers share the host's cores


@pytest.fixture(scope="module")
def water():
    return build_water_system(3.0)


def test_langevin_step_matches_jax(rng):
    """Same coefficients (f64 numpy, bitwise) and, with injected noise, the
    same step to 1e-15."""
    n = 500
    masses = rng.uniform(1.0, 16.0, n)
    masses[3] = np.inf  # frozen atom
    for a, b in zip(tint.langevin_coefficients(300.0, 2.5e-3, 1.0, masses), jint.langevin_coefficients(300.0, 2.5e-3, 1.0, masses)):
        np.testing.assert_array_equal(a, b)
    x, v, f, noise = (rng.normal(size=(n, 3)) for _ in range(4))
    ca, cb, cc = jint.LangevinIntegrator(300.0, 2.5e-3, 1.0, masses, 1).coefficients()
    x_ref, v_ref = jint.langevin_step(x, v, f, noise, ca, cb, cc, 2.5e-3)
    ca, cb, cc = tint.LangevinIntegrator(300.0, 2.5e-3, 1.0, masses, 1).coefficients()
    t = torch.as_tensor
    x_new, v_new = tint.langevin_step(t(x), t(v), t(f), t(noise), ca, t(cb), t(cc), 2.5e-3)
    np.testing.assert_allclose(x_new.numpy(), np.asarray(x_ref), rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(v_new.numpy(), np.asarray(v_ref), rtol=1e-15, atol=1e-15)


def test_barostat_matches_jax_with_its_uniforms(water):
    """30 moves with the adaptive scale evolving: fed the two uniforms that
    JAX draws from each key (jax.random.split), the port accepts and rejects
    the same moves and reaches the same coordinates and box (f64, 1e-12).
    The energy is a smooth stand-in that both frameworks evaluate exactly."""
    n = len(water.conf)
    groups = water.host_topology.group_idxs
    kw = dict(num_atoms=n, pressure=1.013, temperature=300.0, group_idxs=groups, interval=25)
    j_move = jbaro.MonteCarloBarostat(**kw).make_move_fn(lambda x, box: 0.4 * jnp.sum(x**2))
    baro = MonteCarloBarostat(**kw)
    t_move = baro.make_move_with_uniforms(lambda x, box: 0.4 * torch.sum(x**2))
    j_state, t_state = jbaro.MonteCarloBarostat(**kw).init_state(), baro.init_state("cpu", torch.float64)
    jx, jbox = jnp.asarray(water.conf), jnp.asarray(water.box)
    tx, tbox = torch.as_tensor(water.conf), torch.as_tensor(water.box)
    accepted = []
    for i in range(30):
        key = jax.random.fold_in(jax.random.key(11), i)
        k1, k2 = jax.random.split(key)
        u_dv, u_acc = (float(jax.random.uniform(k, dtype=jnp.float64)) for k in (k1, k2))
        j_state, jx, _, jbox = j_move(j_state, jx, jx, jbox, key)
        t_state, tx, _, tbox = t_move(t_state, tx, tx, tbox, u_dv, u_acc)
        assert int(t_state.total_accepted) == int(j_state.total_accepted)
        accepted.append(int(t_state.total_accepted))
    assert 0 < accepted[-1] < 30  # both outcomes exercised
    assert float(t_state.volume_scale) == pytest.approx(float(j_state.volume_scale), rel=1e-12)
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=1e-12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)


def test_fire_matches_jax(water):
    """50 FIRE steps on the bond + angle terms of a water box whose atoms
    were jittered by 0.01 nm (f64): same trajectory to 1e-10 nm (same
    update rule; the forces differ in summation order only)."""
    cfg = host_config_from_jax(water)
    terms = (cfg.host_system.bond, cfg.host_system.angle)
    jterms = (water.host_system.bond, water.host_system.angle)
    box = torch.as_tensor(water.box)
    x0 = np.asarray(water.conf, np.float64) + np.random.default_rng(3).normal(0, 0.01, water.conf.shape)

    def j_force(x):
        return -jax.grad(lambda c: sum(bp.potential(c, jnp.asarray(bp.params, jnp.float64), None) for bp in jterms))(x)

    x_ref = fire_minimize_jax(jnp.asarray(x0), jax.jit(j_force), JaxFireConfig(50))
    x = fire_minimize(torch.as_tensor(x0), lambda c: sum(p.energy_force(c, box)[1] for p in terms), FireMinimizationConfig(50))
    assert np.abs(x.numpy() - x0).max() > 1e-3  # it moved
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-10)


def test_context_matches_jax_context(water):
    """Langevin steps at T = 0 (dt 1 fs) from the same unrelaxed water box:
    the port's Context (f64, rowscan provider rebuilt at steps 0 and 20)
    against the JAX Context (f64, dense exact-erfc nonbonded). The two
    differ by the polynomial fit of the electrostatics (3.4e-4 of the net
    force): after 1 step by 3.8e-7 nm (tolerance 2e-6), after 40 steps, as
    atoms move up to 0.2 nm out of their clashes, by 1.5e-4 nm (tolerance
    5e-4). A step rule, force sign or list rebuild gone wrong is off by
    orders of magnitude more."""
    masses = np.asarray(water.masses)
    v0 = sample_velocities(masses, 300.0, seed=5)
    box = np.asarray(water.box)
    j_intg = jint.LangevinIntegrator(0.0, 1e-3, 1.0, masses, seed=1)
    j_ctxt = JaxContext(np.asarray(water.conf), v0, box, j_intg, water.host_system.get_U_fns())

    cfg = host_config_from_jax(water)
    x0, b0 = torch.as_tensor(cfg.conf), torch.as_tensor(cfg.box)
    cfg.host_system.nonbonded_all_pairs.configure(b0, x0)
    ctxt = Context(x0, v0, b0, tint.LangevinIntegrator(0.0, 1e-3, 1.0, masses, seed=1), cfg.host_system.get_U_fns())
    for n, tol in ((1, 2e-6), (39, 5e-4)):
        j_ctxt.multiple_steps(n)
        ctxt.multiple_steps(n)
        np.testing.assert_allclose(ctxt.get_x_t(), j_ctxt.get_x_t(), atol=tol)
    assert np.abs(ctxt.get_x_t() - np.asarray(water.conf)).max() > 0.1
