"""Importance-reweighting estimators of free energies, differentiable in the
forcefield parameters (counterpart of timemachine_tpu/fe/reweighting.py).

The estimators call batched reduced-potential functions
`batched_u_fxn(samples, params) -> (N,)`; built from potentials' `u(x,
params, box)`, their gradients reach the parameters through autograd.
"""

from __future__ import annotations

import math
from typing import Callable, Collection

import numpy as np
import torch

Samples = Collection
Params = Collection
BatchedReducedPotentialFxn = Callable

__all__ = [
    "construct_endpoint_reweighting_estimator",
    "construct_mixture_reweighting_estimator",
    "interpret_as_mixture_potential",
    "one_sided_exp",
]


def log_mean(log_values):
    """Stable log(mean(values)) = logsumexp(log_values) - log(N)."""
    log_values = torch.as_tensor(log_values)
    return torch.logsumexp(log_values - math.log(len(log_values)), dim=0)


def estimate_log_z_ratio(log_importance_weights):
    return log_mean(log_importance_weights)


def one_sided_exp(delta_us):
    """EXP (Zwanzig): delta_f = -log <exp(-delta_u)>."""
    return -estimate_log_z_ratio(-torch.as_tensor(delta_us))


def interpret_as_mixture_potential(u_kn, f_k, N_k):
    """u_mix(x_n) of the N_k-weighted mixture of the K source states.

    u_kn: (K, N) reduced energies of all pooled samples in all states;
    f_k: (K,) reduced free energies; N_k: per-state sample counts."""
    u_kn = torch.as_tensor(u_kn)
    f_k = torch.as_tensor(f_k, dtype=u_kn.dtype)
    N_k = np.asarray(N_k)
    K, N = u_kn.shape
    if f_k.shape != (K,) or np.sum(N_k) != N:
        raise ValueError(f"want f_k of shape ({K},) and N_k summing to {N}")
    log_w_k = torch.as_tensor(np.log(N_k) - np.log(np.sum(N_k)), dtype=u_kn.dtype, device=u_kn.device)
    # p_k(x) ~ exp(f_k - u_k(x)), mixed over k with weights w_k
    return -torch.logsumexp(log_w_k[:, None] + f_k[:, None] - u_kn, dim=0)


def construct_endpoint_reweighting_estimator(
    samples_0: Collection,
    samples_1: Collection,
    batched_u_0_fxn: Callable,
    batched_u_1_fxn: Callable,
    ref_params,
    ref_delta_f: float,
) -> Callable:
    """Estimator of f(params, 1) - f(params, 0) from endpoint samples drawn at
    ref_params, by the cycle delta_f(params) = delta_f(ref) - reweight_0 +
    reweight_1. Differentiable in params."""
    with torch.no_grad():
        ref_u_0 = batched_u_0_fxn(samples_0, ref_params)
        ref_u_1 = batched_u_1_fxn(samples_1, ref_params)

    def estimate_delta_f(params):
        df_0 = one_sided_exp(batched_u_0_fxn(samples_0, params) - ref_u_0)
        df_1 = one_sided_exp(batched_u_1_fxn(samples_1, params) - ref_u_1)
        return ref_delta_f - df_0 + df_1

    return estimate_delta_f


def construct_mixture_reweighting_estimator(
    samples_n: Collection,
    u_ref_n,
    batched_u_0_fxn: Callable,
    batched_u_1_fxn: Callable,
) -> Callable:
    """Estimator of f(params, 1) - f(params, 0) by reweighting one reference
    ensemble (e.g. the MBAR mixture, u_ref_n its reduced energies) to both
    end states. Differentiable in params."""
    u_ref_n = torch.as_tensor(u_ref_n)
    if len(samples_n) != len(u_ref_n):
        raise ValueError("one reference energy per sample")

    def estimate_delta_f(params):
        f_0 = one_sided_exp(batched_u_0_fxn(samples_n, params) - u_ref_n)
        f_1 = one_sided_exp(batched_u_1_fxn(samples_n, params) - u_ref_n)
        return f_1 - f_0

    return estimate_delta_f
