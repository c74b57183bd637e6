"""Analytic 1-D Gaussian alchemical test system (counterpart of
timemachine_tpu/testsystems/gaussian1d.py): drives HREX, SMC, BAR and
reweighting tests without MD, with exact log densities and free energies.
"""

from __future__ import annotations

import numpy as np


def make_gaussian_testsystem(mu0=0.0, sigma0=1.0, mu1=1.0, sigma1=2.0):
    """λ-interpolated family of Gaussians with plain quadratic reduced
    energies u(x; λ) = (x - μ(λ))² / (2 σ(λ)²), μ/σ linear in λ.

    Returns (u_fn(x, lamb), sample_fn(lamb, n, seed), exact_delta_f(l0, l1))
    where Δf(λ0→λ1) = log(σ(λ0)/σ(λ1)) exactly.
    """

    def params(lamb):
        return (1 - lamb) * mu0 + lamb * mu1, (1 - lamb) * sigma0 + lamb * sigma1

    def u_fn(x, lamb):
        mu, sigma = params(lamb)
        return (np.asarray(x) - mu) ** 2 / (2 * sigma**2)

    def sample_fn(lamb, n, seed=0):
        mu, sigma = params(lamb)
        return np.random.default_rng(seed).normal(mu, sigma, n)

    def exact_delta_f(lamb_from, lamb_to):
        _, s_from = params(lamb_from)
        _, s_to = params(lamb_to)
        return float(np.log(s_from / s_to))

    return u_fn, sample_fn, exact_delta_f


def make_gaussian_ukln(lambdas, n_samples=2000, seed=0, **kwargs):
    """(n_windows-1, 2, 2, n) pair u_kln stack + exact pair Δfs."""
    u_fn, sample_fn, exact_delta_f = make_gaussian_testsystem(**kwargs)
    ukln_by_lambda = []
    exact = []
    for i in range(len(lambdas) - 1):
        l0, l1 = lambdas[i], lambdas[i + 1]
        x0 = sample_fn(l0, n_samples, seed + 2 * i)
        x1 = sample_fn(l1, n_samples, seed + 2 * i + 1)
        u_kln = np.zeros((2, 2, n_samples))
        u_kln[0, 0] = u_fn(x0, l0)
        u_kln[0, 1] = u_fn(x0, l1)
        u_kln[1, 0] = u_fn(x1, l0)
        u_kln[1, 1] = u_fn(x1, l1)
        ukln_by_lambda.append(u_kln)
        exact.append(exact_delta_f(l0, l1))
    return np.array(ukln_by_lambda), np.array(exact)
