"""Standalone integrators and the batched vacuum `simulate` (the port of
timemachine_tpu/integrator.py).

The Context's integrators are in integrators.py; this module is the small
self-contained surface for cross-checks and vacuum sampling. Forces come
from a force function (or, in `simulate`, from autograd of an energy) on
the device of the coordinates it is given. The Langevin noise is a tensor
of draws, a torch.Generator's, or numpy's `rng` where JAX's takes numpy's
too: where JAX splits a jax.random key, the port takes a torch.Generator,
and the functions equal JAX's given the same draws (ROADMAP P31, P33).
"""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch.device import resolve_device, working_dtype
from timemachine_torch.integrators import langevin_coefficients, langevin_step

__all__ = [
    "langevin_coefficients",
    "langevin_trajectory",
    "velocity_verlet_trajectory",
    "LangevinIntegrator",
    "VelocityVerletIntegrator",
    "simulate",
]

DT, FRICTION = 1.5e-3, 1.0  # simulate's step (ps) and friction (1/ps), as in JAX's


def _draws(noise, n_steps: int, x):
    """Step t's noise: noise[t] of an (n_steps, *x.shape) tensor, or a
    fresh normal draw from a torch.Generator on x's device."""
    if isinstance(noise, torch.Generator):
        return lambda t: torch.randn(x.shape, generator=noise, device=x.device, dtype=x.dtype)
    noise = torch.as_tensor(noise, device=x.device, dtype=x.dtype)
    if noise.shape != (n_steps, *x.shape):
        raise ValueError(f"noise must have shape {(n_steps, *x.shape)}, got {tuple(noise.shape)}")
    return lambda t: noise[t]


def langevin_trajectory(x, v, force_fn, noise, ca, cb, cc, n_steps: int, dt):
    """n_steps of the half-step-rotated BAOAB update from tensors (x, v):
    v_mid = v + cb F(x), v' = ca v_mid + cc noise, x' = x + dt/2 (v_mid + v').
    noise: an (n_steps, N, 3) tensor or a torch.Generator. Returns (xs, vs),
    each (n_steps + 1, N, 3) with the initial state first."""
    draw = _draws(noise, n_steps, x)
    cb, cc = (torch.as_tensor(np.asarray(c), device=x.device, dtype=x.dtype) for c in (cb, cc))
    xs, vs = [x], [v]
    for t in range(n_steps):
        x, v = langevin_step(x, v, force_fn(x), draw(t), float(ca), cb, cc, dt)
        xs.append(x)
        vs.append(v)
    return torch.stack(xs), torch.stack(vs)


def velocity_verlet_trajectory(x, v, force_fn, cb, n_steps: int, dt):
    """Deterministic leapfrog with one force evaluation a step and explicit
    initial and final half kicks; (xs, vs), each (n_steps + 1, N, 3), with
    on-step velocities at the first and last frames (JAX's layout)."""
    cb = torch.as_tensor(np.asarray(cb), device=x.device, dtype=x.dtype)
    v_half = v + 0.5 * cb * force_fn(x)
    xs, vs = [x, x + dt * v_half], [v, v_half]
    for _ in range(n_steps - 1):
        vs.append(vs[-1] + cb * force_fn(xs[-1]))
        xs.append(xs[-1] + dt * vs[-1])
    if n_steps > 1:  # the trailing half kick puts the last velocity on step
        vs[-1] = vs[-1] + 0.5 * cb * force_fn(xs[-1])
    return torch.stack(xs), torch.stack(vs)


class LangevinIntegrator:
    """The reference surface over langevin_trajectory on `device` (None:
    the card) in its working dtype: inputs are moved there, and force_fxn
    maps a tensor x there to its force."""

    def __init__(self, force_fxn, masses, temperature, dt, friction, device=None):
        self.dt = dt
        self.force_fxn = force_fxn
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        ca, cb, cc = langevin_coefficients(temperature, dt, friction, masses)
        self.ca = ca
        self.cb = np.expand_dims(cb, -1)
        self.cc = np.expand_dims(cc, -1)

    def _t(self, a):
        return torch.as_tensor(a, device=self.device, dtype=self.dtype)

    def _step(self, x, v, noise):
        x, v = self._t(x), self._t(v)
        return langevin_step(x, v, self.force_fxn(x), self._t(noise), float(self.ca), self._t(self.cb),
                             self._t(self.cc), self.dt)

    def step(self, x, v, rng: np.random.Generator):
        """One step with numpy's normal draws from rng, as JAX's step."""
        return self._step(x, v, rng.normal(size=np.shape(x)))

    def step_lax(self, generator: torch.Generator, x, v):
        """One step with normal draws from a torch.Generator on the device."""
        x = self._t(x)
        return self._step(x, v, torch.randn(x.shape, generator=generator, device=self.device, dtype=self.dtype))

    def multiple_steps(self, x, v, n_steps: int = 1000, rng=None):
        """(xs, vs) numpy, (n_steps + 1, N, 3), stepping with numpy draws."""
        rng = rng or np.random.default_rng()
        xs, vs = [self._t(x)], [self._t(v)]
        for _ in range(n_steps):
            x, v = self.step(xs[-1], vs[-1], rng)
            xs.append(x)
            vs.append(v)
        return torch.stack(xs).cpu().numpy(), torch.stack(vs).cpu().numpy()

    def multiple_steps_lax(self, generator: torch.Generator, x, v, n_steps: int = 1000):
        """langevin_trajectory with the noise from a torch.Generator on the
        device (JAX's from a jax.random key)."""
        return langevin_trajectory(self._t(x), self._t(v), self.force_fxn, generator, self.ca, self.cb, self.cc,
                                   n_steps, self.dt)


class VelocityVerletIntegrator:
    """The reference surface over velocity_verlet_trajectory on `device`
    (None: the card) in its working dtype."""

    def __init__(self, force_fxn, masses, dt, device=None):
        self.dt = dt
        self.force_fxn = force_fxn
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self.cb = dt / np.asarray(masses)[:, None]

    def _t(self, a):
        return torch.as_tensor(a, device=self.device, dtype=self.dtype)

    def step(self, x, v):
        x, v, cb = self._t(x), self._t(v), self._t(self.cb)
        v_mid = v + 0.5 * cb * self.force_fxn(x)
        x_new = x + self.dt * v_mid
        v_new = v_mid + 0.5 * cb * self.force_fxn(x_new)
        return x_new.cpu().numpy(), v_new.cpu().numpy()

    def multiple_steps(self, x, v, n_steps: int = 1000):
        xs, vs = velocity_verlet_trajectory(self._t(x), self._t(v), self.force_fxn, self.cb, n_steps, self.dt)
        return xs.cpu().numpy(), vs.cpu().numpy()


def simulate(x0, U_fn, temperature, masses, steps_per_batch, num_batches, num_workers, seed=None, device=None):
    """Vacuum Langevin of num_workers walkers from x0 at rest, advanced
    together on `device` (None: the card) in its working dtype, dt 1.5e-3 ps,
    friction 1/ps, forces by autograd of U_fn (one conformer (N, 3), a
    tensor there, to its energy); a frame after every steps_per_batch steps.
    The noise of all walkers comes from one torch.Generator seeded with
    `seed` (None: the clock), where JAX keys walker w with seed + w (P31).

    Returns (xs, vs), each (num_workers, num_batches, N, 3) numpy."""
    from timemachine_torch.md.enhanced import _simulate

    device = resolve_device(device)
    dtype = working_dtype(device)
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (1 << 63))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x0 = torch.as_tensor(np.asarray(x0), device=device, dtype=dtype)
    x = x0[None].repeat(num_workers, 1, 1)
    v = torch.zeros_like(x)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    return _simulate(x, v, U_fn, temperature, masses, DT, FRICTION, steps_per_batch, num_batches, draw)
