"""FIRE descent (Bitzek et al. 2006, PRL 97:170201)
(counterpart of timemachine_tpu/md/fire.py; same update rule).

Step-size and mixing decisions are torch.where on 0-d device tensors, so a
descent on the card never syncs the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch


@dataclass(frozen=True)
class FireMinimizationConfig:
    n_steps: int
    dt_start: float = 1e-5
    dt_max: float = 1e-3
    n_min: float = 5
    f_inc: float = 1.1
    f_dec: float = 0.5
    alpha_start: float = 0.1
    f_alpha: float = 0.99


@dataclass(frozen=True)
class ScipyMinimizationConfig:
    """scipy.optimize.minimize's method, options and bounds."""

    method: str
    options: Optional[dict] = None
    bounds: Optional[Any] = None


def fire_descent(force: Callable, config: FireMinimizationConfig):
    """(init_fn, apply_fn) over the state (x, v, f, dt, alpha, n_pos), in
    free space."""
    c = config

    def init_fn(x):
        return (
            x, torch.zeros_like(x), force(x), x.new_tensor(c.dt_start), x.new_tensor(c.alpha_start),
            torch.zeros((), dtype=torch.int32, device=x.device),
        )

    def apply_fn(state):
        x, v, f_old, dt, alpha, n_pos = state
        x = x + (dt * v + dt**2 * f_old)
        f = force(x)
        v = v + dt * 0.5 * (f_old + f)

        f_norm = torch.sqrt(torch.sum(f**2) + 1e-6)
        v_norm = torch.sqrt(torch.sum(v**2))
        p = torch.sum(f * v)
        v = v + alpha * (f * v_norm / f_norm - v)

        n_pos = torch.where(p >= 0, n_pos + 1, 0)
        grow = (p > 0) & (n_pos > c.n_min)
        dt = torch.where(grow, torch.clamp(dt * c.f_inc, max=c.dt_max), dt)
        dt = torch.where(p < 0, dt * c.f_dec, dt)
        alpha = torch.where(grow, alpha * c.f_alpha, alpha)
        alpha = torch.where(p < 0, c.alpha_start, alpha)
        v = torch.where(p < 0, 0.0, v)
        return (x, v, f, dt, alpha, n_pos)

    return init_fn, apply_fn


def fire_minimize(x0, force_fn: Callable, config: FireMinimizationConfig):
    """config.n_steps of FIRE from x0; force_fn(x) -> (N, 3) force."""
    init_fn, apply_fn = fire_descent(force_fn, config)
    with torch.no_grad():
        state = init_fn(x0)
        for _ in range(config.n_steps):
            state = apply_fn(state)
    return state[0]
