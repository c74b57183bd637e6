"""Barker proposal (Livingstone & Zanella 2020, arXiv:1908.11812): the port
of timemachine_tpu/md/barker.py.

A gradient-informed proposal that is robust to clashes and to poor step
sizes, used for host equilibration (md/minimizer.equilibrate_host_barker).
Proposal: y = x + b z with z ~ N(0, sigma^2) per coordinate and b = +-1,
P(b = +1 | x, z) = sigmoid(grad log q(x) z); the joint proposal density's
normalizing constant is 1/2 per coordinate (the paper's proposition 3.1).

The chain is a Python loop over steps on the device of x, each step one
gradient evaluation. Its z and u come from a torch.Generator where JAX
splits a jax.random key; given the same draws it is JAX's chain (ROADMAP
P30).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def barker_step(x, grad_log_q, z, u):
    """The proposal given its draws: z (sigma-scaled normals) and u
    (uniforms), each of x's shape. The sign of z flips where log u >
    log sigmoid(grad_log_q z)."""
    flip = torch.log(u) > F.logsigmoid(grad_log_q * z)
    return x + torch.where(flip, -z, z)


def barker_draws(generator: torch.Generator, x, sigma):
    """(z, u) of one proposal: sigma N(0, 1) and U[0, 1) draws of x's shape,
    dtype and device, z first."""
    z = sigma * torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return z, u


def barker_propose(generator: torch.Generator, x, grad_log_q, sigma):
    """One Barker proposal draw y ~ p(. | x), given grad log q(x)."""
    z, u = barker_draws(generator, x, sigma)
    return barker_step(x, grad_log_q, z, u)


def barker_log_density(x, y, grad_log_q_x, sigma):
    """log p(y | x) (the paper's eq. 16), summed over coordinates."""
    x, y, g = (torch.as_tensor(a, dtype=torch.float64) for a in (x, y, grad_log_q_x))
    z = y - x
    log_normal = -0.5 * (z / sigma) ** 2 - math.log(sigma) - 0.5 * math.log(2.0 * math.pi)
    return torch.sum(log_normal + F.logsigmoid(g * z)) - math.log(0.5)


def barker_chain(generator: torch.Generator, x0, grad_log_q_fn, sigma, n_steps: int):
    """n_steps un-Metropolized Barker updates from x0 (a tensor), each
    with grad_log_q_fn(x) (for a Boltzmann target -dU/dx / kT) at the
    current x and its draws from `generator` by barker_draws, so a generator
    seeded alike replays them. Returns the final state."""
    x = x0
    for _ in range(n_steps):
        x = barker_propose(generator, x, grad_log_q_fn(x), sigma)
    return x
