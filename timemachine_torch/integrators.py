"""Langevin integrator, BAOAB with a half-step rotation
(counterpart of timemachine_tpu/integrators.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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

    def coefficients(self):
        """(ca, cb (N, 1), cc (N, 1)) in numpy f64."""
        ca, cb, cc = langevin_coefficients(self.temperature, self.dt, self.friction, self.masses)
        return ca, cb[:, None], cc[:, None]
