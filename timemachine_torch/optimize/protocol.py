"""λ-protocol optimization by reweighting already-collected samples (the
port of timemachine_tpu/optimize/protocol.py, in numpy).

Given (lambdas, u_kn, f_k, N_k) from a pilot run, estimate a thermodynamic
distance between any two λ values, either the work's standard deviation or
1 - overlap, by treating the pooled samples as draws from the MBAR mixture
and interpolating each sample's energy linearly in λ. A greedy left-to-right
pass then places windows at equal distance. Post-processing only: no new
simulation. The interpolant repeats jnp.interp's arithmetic (clamped ends,
non-finite energies as +inf), so the distances are the JAX package's to
rounding.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np
from scipy.optimize import bisect
from scipy.special import logsumexp

from timemachine_torch.fe.reweighting import interpret_as_mixture_potential

DistanceFxn = Callable[[float, float], float]


def log_weights_from_mixture(u_kn, f_k, N_k):
    """Log unnormalized MBAR mixture density of each pooled sample:
    log sum_k N_k exp(f_k - u_k(x_n))."""
    return logsumexp(
        np.asarray(f_k, dtype=np.float64)[:, None] - np.asarray(u_kn, dtype=np.float64),
        b=np.asarray(N_k, dtype=np.float64)[:, None],
        axis=0,
    )


def linear_u_kn_interpolant(lambdas, u_kn) -> Callable:
    """vec_u(λ)[n] ≈ u(x_n, λ) by per-sample linear interpolation over the
    source λ grid, clamped at its ends; non-finite energies give +inf."""
    xp = np.asarray(lambdas, dtype=np.float64)
    u_kn = np.asarray(u_kn, dtype=np.float64)
    eps = np.spacing(np.finfo(xp.dtype).eps)

    def vec_u(lam):
        lam = float(lam)
        i = int(np.clip(np.searchsorted(xp, lam, side="right"), 1, len(xp) - 1))
        dx = xp[i] - xp[i - 1]
        dx0 = abs(dx) <= eps
        with np.errstate(invalid="ignore"):
            df = u_kn[i] - u_kn[i - 1]
            f = u_kn[i - 1] if dx0 else u_kn[i - 1] + ((lam - xp[i - 1]) / dx) * df
        if lam < xp[0]:
            f = u_kn[0]
        elif lam > xp[-1]:
            f = u_kn[-1]
        return np.nan_to_num(f, nan=np.inf, posinf=np.inf)

    return vec_u


@dataclass(frozen=True)
class _MixtureReweighter:
    """Pooled pilot samples viewed as draws from the MBAR mixture, with a
    λ-interpolated energy model: what both distance families read."""

    vec_u: Callable  # λ -> per-sample energies
    source_logpdf_n: np.ndarray  # log density the samples were drawn from

    @classmethod
    def from_pilot(cls, lambdas, u_kn, f_k, N_k, *, mixture_log_weights: bool):
        vec_u = linear_u_kn_interpolant(lambdas, np.nan_to_num(u_kn, nan=np.inf))
        if mixture_log_weights:
            source = log_weights_from_mixture(u_kn, f_k, N_k)
        else:
            source = interpret_as_mixture_potential(np.asarray(u_kn, np.float64), f_k, N_k).numpy()
        return cls(vec_u, source)

    def work_stddev(self, lam_from: float, lam_to: float):
        """Standard deviation of the instantaneous work λ_from -> λ_to under p(λ_from)."""
        target_logpdf = -self.vec_u(lam_from)
        with np.errstate(invalid="ignore"):
            works = self.vec_u(lam_to) - self.vec_u(lam_from)
            lw = target_logpdf - self.source_logpdf_n
            w = np.exp(lw - logsumexp(lw)).flatten()
            mean = np.sum(w * works)
            var_terms = np.nan_to_num(w * (works - mean) ** 2, nan=0.0)  # 0 inf -> 0
        return np.sqrt(np.sum(var_terms))

    def overlap(self, lam_a: float, lam_b: float):
        """pymbar-style pair overlap (sec. 3.4 of doi:10.1021/ct501101f),
        all three densities estimated from the same reference samples."""
        log_q_a = -self.vec_u(lam_a)
        log_q_b = -self.vec_u(lam_b)
        log_q_ref = -np.asarray(self.source_logpdf_n)
        log_n = np.log(len(log_q_ref))

        log_p_ref = log_q_ref - logsumexp(log_q_ref - log_n)
        log_p_a = log_q_a - logsumexp(log_q_a - log_p_ref - log_n)
        log_p_b = log_q_b - logsumexp(log_q_b - log_p_ref - log_n)

        log_prod = log_p_a + log_p_b
        log_mix = logsumexp(np.stack([log_p_a, log_p_b]), axis=0) - np.log(2)
        log_denom = log_mix + log_p_ref
        valid = log_denom > -np.inf
        with np.errstate(invalid="ignore"):
            ratios = np.where(valid, log_prod - log_denom, 0.0)
        return np.clip(np.exp(logsumexp(ratios - np.log(np.sum(valid)))), 0.0, 1.0)


def work_stddev_distance_fxn(lambdas, u_kn, f_k, N_k, max_step: float = 0.25) -> DistanceFxn:
    """d(a, b) = max(work_stddev(a -> b), work_stddev(b -> a)); +inf beyond
    max_step so the greedy pass never leaps over unsampled territory."""
    rw = _MixtureReweighter.from_pilot(lambdas, u_kn, f_k, N_k, mixture_log_weights=True)

    def distance(lam_prev, lam_next):
        if lam_next - lam_prev > max_step:
            return +np.inf
        return max(rw.work_stddev(lam_prev, lam_next), rw.work_stddev(lam_next, lam_prev))

    return distance


def make_fast_approx_overlap_distance_fxn(lambdas, u_kn, f_k, N_k) -> DistanceFxn:
    """d(a, b) = 1 - overlap(a, b), reweighted and λ-interpolated."""
    rw = _MixtureReweighter.from_pilot(lambdas, u_kn, f_k, N_k, mixture_log_weights=False)

    def distance(lam_a, lam_b):
        return 1.0 - rw.overlap(lam_a, lam_b)

    return distance


def rebalance_initial_protocol_by_work_stddev(lambdas_k, f_k, u_kn, N_k, work_stddev_threshold: float = 1.0):
    """A new protocol with work_stddev(i -> i ± 1) <= threshold everywhere."""
    distance = work_stddev_distance_fxn(lambdas_k, u_kn, f_k, N_k)
    return greedily_optimize_protocol(distance, target_distance=work_stddev_threshold)


def greedily_optimize_protocol(
    distance_fxn: DistanceFxn,
    target_distance=0.5,
    max_iterations=1000,
    bisection_xtol=1e-4,
    protocol_interval: tuple = (0.0, 1.0),
):
    """Left-to-right placement: each new λ sits at the target thermodynamic
    distance from the previous one (located by scalar bisection); stops when
    the remaining gap to the endpoint is within the target."""
    lam_lo, lam_hi = protocol_interval
    protocol = [lam_lo]

    for iteration in range(max_iterations):
        prev = protocol[-1]
        if distance_fxn(prev, lam_hi) < target_distance:
            break
        protocol.append(
            bisect(
                f=lambda trial: float(distance_fxn(prev, trial)) - target_distance,
                a=prev,
                b=lam_hi,
                xtol=bisection_xtol,
            )
        )
        if iteration == max_iterations - 1:
            warnings.warn("Exceeded max_iterations!")

    if protocol[-1] != lam_hi:
        protocol.append(lam_hi)
    return np.array(protocol)
