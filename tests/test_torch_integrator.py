"""The port's standalone integrators and batched `simulate`
(timemachine_torch/integrator.py) against timemachine_tpu/integrator.py, in
float64 on the CPU, on a small anharmonic chain made from a numpy seed.

The Langevin trajectories are fed JAX's own noise (its jax.random draws,
rebuilt here) or the same numpy Generator, and held to TOL nm and nm/ps;
velocity Verlet is deterministic and held alike. Where the port draws from
a torch.Generator (multiple_steps_lax, simulate: ROADMAP P31, P33), the run
equals the function given those draws and repeats bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from timemachine_torch import integrator as ti

torch.set_num_threads(1)  # the suite's workers share the host's cores

jax.config.update("jax_enable_x64", True)

CPU = torch.device("cpu")
TOL = 1e-10
N, K, R0 = 5, 2000.0, 0.15
TEMP, DT, FRICTION = 300.0, 1.5e-3, 1.0


def _masses():
    return np.array([12.0, 1.0, 16.0, 14.0, 1.0])


def _x0():
    rng = np.random.default_rng(0)
    return np.cumsum(np.full((N, 3), 0.09) + rng.normal(0, 0.01, (N, 3)), axis=0)


def _energy(x, lib):
    """Quartic bonds along a chain plus a weak harmonic pull between its ends."""
    d = x[1:] - x[:-1]
    r2 = (d * d).sum(-1)
    e = x[-1] - x[0]
    return (K * (r2 - R0**2) ** 2).sum() + 5.0 * (e * e).sum()


def _force_t(x):
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(_energy(x, torch), x)
    return -g


def _force_j(x):
    import jax.numpy as jnp

    return -jax.grad(lambda y: _energy(y, jnp))(x)


def _jax_noise(key, n_steps, shape):
    import jax.random as jr

    return np.stack([np.asarray(jr.normal(k, shape)) for k in jr.split(key, n_steps)])


def test_langevin_trajectory_matches_jax_given_its_noise():
    import jax.random as jr
    from timemachine_tpu import integrator as ji

    ca, cb, cc = ji.langevin_coefficients(TEMP, DT, FRICTION, _masses())
    cb, cc = cb[:, None], cc[:, None]
    x0, v0 = _x0(), np.random.default_rng(1).normal(0, 0.3, (N, 3))
    key = jr.key(11)
    xs_j, vs_j = ji.langevin_trajectory(x0, v0, _force_j, key, ca, cb, cc, 40, DT)
    noise = _jax_noise(key, 40, (N, 3))
    xs_t, vs_t = ti.langevin_trajectory(torch.as_tensor(x0), torch.as_tensor(v0), _force_t, torch.as_tensor(noise),
                                        ca, cb, cc, 40, DT)
    assert xs_t.shape == (41, N, 3)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(vs_t.numpy(), np.asarray(vs_j), rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        ti.langevin_trajectory(torch.as_tensor(x0), torch.as_tensor(v0), _force_t, torch.as_tensor(noise[:3]), ca, cb,
                               cc, 40, DT)


def test_langevin_integrator_steps_match_jax_with_one_numpy_generator():
    from timemachine_tpu import integrator as ji

    t_int = ti.LangevinIntegrator(_force_t, _masses(), TEMP, DT, FRICTION, device=CPU)
    j_int = ji.LangevinIntegrator(_force_j, _masses(), TEMP, DT, FRICTION)
    x0, v0 = _x0(), np.zeros((N, 3))
    xs_t, vs_t = t_int.multiple_steps(x0, v0, 10, rng=np.random.default_rng(4))
    xs_j, vs_j = j_int.multiple_steps(x0, v0, 10, rng=np.random.default_rng(4))
    np.testing.assert_allclose(xs_t, xs_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(vs_t, vs_j, rtol=0, atol=TOL)
    x1_t, v1_t = t_int.step(x0, v0, np.random.default_rng(5))
    x1_j, v1_j = j_int.step(x0, v0, np.random.default_rng(5))
    np.testing.assert_allclose(x1_t.numpy(), np.asarray(x1_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(v1_t.numpy(), np.asarray(v1_j), rtol=0, atol=TOL)


def test_multiple_steps_lax_is_the_trajectory_of_its_generator_draws():
    t_int = ti.LangevinIntegrator(_force_t, _masses(), TEMP, DT, FRICTION, device=CPU)
    x0, v0 = torch.as_tensor(_x0()), torch.zeros(N, 3, dtype=torch.float64)

    def gen(seed):
        g = torch.Generator(device=CPU)
        g.manual_seed(seed)
        return g

    xs, vs = t_int.multiple_steps_lax(gen(8), x0, v0, 25)
    xs2, vs2 = t_int.multiple_steps_lax(gen(8), x0, v0, 25)
    assert torch.equal(xs, xs2) and torch.equal(vs, vs2)
    g = gen(8)
    noise = torch.stack([torch.randn((N, 3), generator=g, dtype=torch.float64) for _ in range(25)])
    xs3, vs3 = ti.langevin_trajectory(x0, v0, _force_t, noise, t_int.ca, t_int.cb, t_int.cc, 25, DT)
    assert torch.equal(xs, xs3) and torch.equal(vs, vs3)
    x1, v1 = t_int.step_lax(gen(8), x0, v0)
    assert torch.equal(x1, xs[1]) and torch.equal(v1, vs[1])


@pytest.mark.parametrize("n_steps", [1, 2, 17])
def test_velocity_verlet_matches_jax(n_steps):
    import jax.numpy as jnp
    from timemachine_tpu import integrator as ji

    x0, v0 = _x0(), np.random.default_rng(2).normal(0, 0.3, (N, 3))
    cb = DT / _masses()[:, None]
    xs_j, vs_j = ji.velocity_verlet_trajectory(x0, v0, _force_j, jnp.asarray(cb), n_steps, DT)
    xs_t, vs_t = ti.velocity_verlet_trajectory(torch.as_tensor(x0), torch.as_tensor(v0), _force_t, cb, n_steps, DT)
    assert xs_t.shape == np.shape(xs_j) == (n_steps + 1, N, 3)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(vs_t.numpy(), np.asarray(vs_j), rtol=0, atol=TOL)


def test_velocity_verlet_integrator_matches_jax():
    from timemachine_tpu import integrator as ji

    x0, v0 = _x0(), np.random.default_rng(3).normal(0, 0.3, (N, 3))
    t_int = ti.VelocityVerletIntegrator(_force_t, _masses(), DT, device=CPU)
    j_int = ji.VelocityVerletIntegrator(_force_j, _masses(), DT)
    for a, b in zip(t_int.step(x0, v0), j_int.step(x0, v0)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    for a, b in zip(t_int.multiple_steps(x0, v0, 12), j_int.multiple_steps(x0, v0, 12)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_simulate_matches_jax_given_its_walkers_noise():
    """JAX's simulate keys walker w with seed + w and splits per batch and
    step; fed those draws, the port's walkers (md.enhanced._simulate, which
    simulate runs) are JAX's to TOL."""
    import jax.numpy as jnp
    import jax.random as jr
    from timemachine_tpu import integrator as ji

    from timemachine_torch.md.enhanced import _simulate

    W, B, S, seed = 3, 4, 5, 21
    x0 = _x0()
    xs_j, vs_j = ji.simulate(x0, lambda x: _energy(x, jnp), TEMP, _masses(), S, B, W, seed=seed)
    noise = np.stack([
        np.stack([_jax_noise(kb, S, (N, 3)) for kb in jr.split(jr.key(seed + w), B)]) for w in range(W)
    ])  # (W, B, S, N, 3)
    order = iter(torch.as_tensor(noise).permute(1, 2, 0, 3, 4).reshape(B * S, W, N, 3))
    x = torch.as_tensor(x0)[None].repeat(W, 1, 1)
    xs_t, vs_t = _simulate(x, torch.zeros_like(x), lambda y: _energy(y, torch), TEMP, _masses(), DT, FRICTION, S, B,
                           lambda shape: next(order))
    assert xs_t.shape == np.shape(xs_j) == (W, B, N, 3)
    np.testing.assert_allclose(xs_t, np.asarray(xs_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(vs_t, np.asarray(vs_j), rtol=0, atol=TOL)


def test_simulate_shape_finite_and_bitwise_on_repeat():
    def run(seed):
        return ti.simulate(_x0(), lambda y: _energy(y, torch), TEMP, _masses(), 6, 5, 4, seed=seed, device=CPU)

    xs, vs = run(3)
    assert xs.shape == vs.shape == (4, 5, N, 3) and np.isfinite(xs).all() and np.isfinite(vs).all()
    xs2, vs2 = run(3)
    np.testing.assert_array_equal(xs, xs2)
    np.testing.assert_array_equal(vs, vs2)
    assert not np.array_equal(run(4)[0], xs)
    assert not np.array_equal(xs[0], xs[1])  # the walkers draw apart
