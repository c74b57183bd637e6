"""Langevin integrator, BAOAB with a half-step rotation, and the
velocity Verlet integrator (counterpart of timemachine_tpu/integrators.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ


def langevin_coefficients(temperature, dt, friction, masses):
    """(ca, cb, cc) in numpy f64: heat bath v <- ca v + cc xi, kick
    v <- v + cb F. Infinite masses give cb = cc = 0 (frozen atoms)."""
    kT = BOLTZ * temperature
    masses = np.asarray(masses, dtype=np.float64)
    nscale = np.sqrt(kT / masses)
    ca = np.exp(-friction * dt)
    cb = dt / masses
    cc = np.sqrt(1 - np.exp(-2 * friction * dt)) * nscale
    cb = np.where(np.isfinite(cb), cb, 0.0)
    cc = np.where(np.isfinite(cc), cc, 0.0)
    return ca, cb, cc


def langevin_step(x, v, force, noise, ca, cb, cc, dt):
    """One step:
        v_mid = v + cb F(x)
        v'    = ca v_mid + cc xi
        x'    = x + dt/2 (v_mid + v')
    cb and cc broadcast per atom: scalars or (N, 1)."""
    v_mid = v + cb * force
    v_new = ca * v_mid + cc * noise
    return x + 0.5 * dt * (v_mid + v_new), v_new


@dataclass(frozen=True)
class LangevinIntegrator:
    temperature: float
    dt: float
    friction: float
    masses: np.ndarray
    seed: int

    def coefficients(self, free_mask: Optional[np.ndarray] = None):
        """(ca, cb (N, 1), cc (N, 1)) in numpy f64; with free_mask (N,),
        cb and cc are zero on the atoms it leaves out (frozen)."""
        ca, cb, cc = langevin_coefficients(self.temperature, self.dt, self.friction, self.masses)
        cb, cc = cb[:, None], cc[:, None]
        if free_mask is not None:
            m = np.asarray(free_mask, dtype=np.float64)[:, None]
            cb, cc = cb * m, cc * m
        return ca, cb, cc


@dataclass(frozen=True)
class VelocityVerletIntegrator:
    """Deterministic leapfrog: a Context enters the half-step velocity
    lattice with a -1/2 kick, takes kick-drift steps, and leaves it with a
    +1/2 kick (JAX's Context contract)."""

    dt: float
    masses: np.ndarray

    def coefficients(self):
        """(ca, cb (N, 1), cc (N, 1)) = (1, dt/m, 0) in numpy f64; infinite
        masses give cb = 0 (frozen atoms)."""
        cb = self.dt / np.asarray(self.masses, dtype=np.float64)
        cb = np.where(np.isfinite(cb), cb, 0.0)[:, None]
        return 1.0, cb, np.zeros_like(cb)


def _standard_normals(generator: torch.Generator, shape, dtype):
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)


def sample_velocities(masses, temperature, generator: torch.Generator, dtype=torch.float64):
    """Maxwell-Boltzmann velocities, (N, 3) on the generator's device: the
    normals are drawn from `generator` where JAX's function takes a key
    (ROADMAP P38)."""
    m = torch.as_tensor(np.asarray(masses, dtype=np.float64), dtype=dtype, device=generator.device)
    sigma = torch.sqrt(BOLTZ * temperature / m)[:, None]
    return sigma * _standard_normals(generator, (len(m), 3), dtype)
