"""Sequential Monte Carlo along an alchemical λ coordinate (the port of
timemachine_tpu/md/smc.py): annealed importance sampling with resampling,
reweight -> resample -> propagate per window, fixed or CESS-adaptive λ
placement (Zhou, Johansen & Aston 2016), multinomial, stratified and
conditional resamplers, endstate sample extraction. Log-space numpy
throughout; the walkers are moved by the caller's `propagate` (on the card,
md/moves.py's NPTMove).

The JAX package's resamplers draw from numpy's global stream; here each
takes `rng`, a numpy RandomState or Generator (None: a fresh default_rng()).
A RandomState seeded as JAX seeds the global stream gives its draws bitwise
(ROADMAP P25).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
from scipy.optimize import root_scalar
from scipy.special import logsumexp

Samples = Sequence[Any]
BatchPropagator = Callable
BatchLogProb = Callable
FindNextLambda = Callable
Resampler = Callable


class SMCMaxIterError(Exception):
    """SMC exceeded the maximum number of iterations."""


# -- weight algebra -----------------------------------------------------------


def _normalized(log_weights) -> np.ndarray:
    lw = np.asarray(log_weights, dtype=float)
    return lw - logsumexp(lw)


def effective_sample_size(log_weights) -> float:
    """ESS = 1/Σ wᵢ² = exp(−logsumexp(2·log w̄)) ∈ [1, N]."""
    return float(np.exp(-logsumexp(2.0 * _normalized(log_weights))))


def conditional_effective_sample_size(norm_log_weights, incremental_log_weights) -> float:
    """CESS of Zhou/Johansen/Aston 2016 eq. 3.16, in log space."""
    lw = np.asarray(norm_log_weights, dtype=float)
    inc = np.asarray(incremental_log_weights, dtype=float)
    n = len(lw)
    return float(n * np.exp(2.0 * logsumexp(lw + inc) - logsumexp(lw + 2.0 * inc)))


# -- resamplers ---------------------------------------------------------------
# Each maps log_weights -> (ancestor indices, post-resampling log_weights).


def _flattened_log_weights(log_weights) -> np.ndarray:
    """After an exact resampling step every walker carries the average
    weight: log(Z_hat / n) replicated."""
    n = len(log_weights)
    return np.full(n, logsumexp(np.asarray(log_weights, dtype=float)) - np.log(n))


def identity_resample(log_weights):
    return np.arange(len(log_weights)), np.asarray(log_weights, dtype=float)


def _rng(rng):
    return np.random.default_rng() if rng is None else rng


def multinomial_resample(log_weights, rng=None):
    """iid ancestor draws ∝ weights."""
    p = np.exp(_normalized(log_weights))
    ancestors = _rng(rng).choice(len(p), size=len(p), p=p / p.sum())
    return ancestors, _flattened_log_weights(log_weights)


def stratified_resample(log_weights, rng=None):
    """One uniform draw per 1/n stratum of the CDF (Douc/Cappé/Moulines
    2005), located by searchsorted — lower variance than multinomial."""
    n = len(log_weights)
    strata = (np.arange(n) + _rng(rng).random(n)) / n
    cdf = np.cumsum(np.exp(_normalized(log_weights)))
    cdf[-1] = 1.0  # guard roundoff at the top stratum
    ancestors = np.searchsorted(cdf, strata, side="right")
    return ancestors, _flattened_log_weights(log_weights)


def conditional_multinomial_resample(log_weights, thresh: float = 0.5, rng=None):
    """Resample only when fractional ESS sinks below thresh."""
    if effective_sample_size(log_weights) < thresh * len(log_weights):
        return multinomial_resample(log_weights, rng)
    return identity_resample(log_weights)


# -- λ placement --------------------------------------------------------------


def fixed_find_next_lambda(samples, current_lambda, current_iteration, norm_log_weights, log_prob, lambdas):
    """Walk a preset schedule; incremental weights from the density ratio."""
    assert lambdas[-1] == 1.0, "final lambda must be 1.0"
    lam_next = lambdas[current_iteration + 1]
    inc = np.asarray(log_prob(samples, lam_next, True)) - np.asarray(log_prob(samples, current_lambda, True))
    return lam_next, inc


def adaptive_find_next_lambda(
    samples,
    current_lambda,
    current_iteration,
    norm_log_weights,
    log_prob,
    cess_target: float = 0.2,
    epsilon: float = 1e-2,
    max_iterations: int = 100,
    final_lambda: float = 1.0,
):
    """Place the next λ where CESS crosses cess_target (bisection); jump to
    final_lambda when even that keeps CESS above target."""
    n = len(samples)
    assert 1 < cess_target < n, f"cess_target must lie in (1, {n}), got {cess_target}"
    if current_iteration == max_iterations:
        raise SMCMaxIterError(f"SMC exceeded maximum number of iterations {max_iterations}.")

    base_log_prob = np.asarray(log_prob(samples, current_lambda, True))

    def incremental_at(lam):
        return np.asarray(log_prob(samples, lam, False)) - base_log_prob

    def gap(lam):
        return conditional_effective_sample_size(norm_log_weights, incremental_at(lam)) - cess_target

    try:
        lam_next = root_scalar(gap, bracket=(current_lambda, final_lambda), method="bisect", xtol=epsilon).root
    except ValueError:
        # no sign change in the bracket: the full jump already satisfies CESS
        lam_next = final_lambda
    return lam_next, incremental_at(lam_next)


# -- driver -------------------------------------------------------------------


@dataclass
class _Trace:
    """Per-iteration records; `asdict` gives the JAX package's result layout."""

    traj: list = field(default_factory=list)
    log_weights_traj: list = field(default_factory=list)
    ancestry_traj: list = field(default_factory=list)
    incremental_log_weights_traj: list = field(default_factory=list)
    lambdas_traj: list = field(default_factory=list)
    keep_intermediates: bool = True

    def record_samples(self, samples):
        if self.keep_intermediates or not self.traj:
            self.traj.append(samples)
        else:
            self.traj[0] = samples

    def asdict(self):
        return dict(
            traj=self.traj,
            log_weights_traj=np.array(self.log_weights_traj),
            ancestry_traj=np.array(self.ancestry_traj),
            incremental_log_weights_traj=np.array(self.incremental_log_weights_traj),
            lambdas_traj=np.array(self.lambdas_traj),
        )


def sequential_monte_carlo(
    samples: Samples,
    propagate: BatchPropagator,
    log_prob: BatchLogProb,
    resample: Resampler,
    find_next_lambda: FindNextLambda,
    store_intermediate_traj: bool = True,
    max_num_lambdas: int = 1000,
) -> dict:
    """Anneal walkers from λ=0 to λ=1.

    Per window: find_next_lambda gives (λ', incremental log-weights); walkers
    are resampled under the updated weights and propagated at λ'. The final
    reweighting onto λ=1 is recorded without propagation. Returns a dict with
    keys traj, log_weights_traj, ancestry_traj, incremental_log_weights_traj,
    lambdas_traj (the JAX package's layout).
    """
    n = len(samples)
    log_weights = np.zeros(n)

    trace = _Trace(keep_intermediates=store_intermediate_traj)
    trace.record_samples(samples)
    trace.ancestry_traj.append(np.arange(n))
    trace.log_weights_traj.append(log_weights.copy())
    trace.lambdas_traj.append(0.0)

    lam = 0.0
    for iteration in range(max_num_lambdas):
        lam_next, incremental = find_next_lambda(trace.traj[-1], lam, iteration, _normalized(log_weights))

        if lam_next == 1.0:
            # terminal reweighting only — no resample/propagate at λ=1
            trace.incremental_log_weights_traj.append(np.asarray(incremental))
            trace.log_weights_traj.append(log_weights + incremental)
            trace.lambdas_traj.append(lam_next)
            return trace.asdict()

        ancestors, log_weights = resample(log_weights + incremental)
        moved = propagate([trace.traj[-1][i] for i in ancestors], lam_next)

        trace.record_samples(moved)
        trace.ancestry_traj.append(ancestors)
        trace.log_weights_traj.append(np.asarray(log_weights).copy())
        trace.incremental_log_weights_traj.append(np.asarray(incremental))
        trace.lambdas_traj.append(lam_next)
        lam = lam_next

    raise SMCMaxIterError(f"SMC exceeded maximum number of iterations {max_num_lambdas}.")


# -- endstate extraction ------------------------------------------------------


def refine_samples(samples, log_weights, propagate: BatchPropagator, lam: float, rng=None):
    """Equal-weight resample, then decorrelate with one propagation sweep."""
    ancestors, flat = multinomial_resample(log_weights, rng)
    assert np.isclose(np.std(flat), 0.0), "resampler must flatten the weights"
    return propagate([samples[i] for i in ancestors], lam)


def get_endstate_samples_from_smc_result(smc_result: dict, propagate: BatchPropagator, lambdas, rng=None):
    first = refine_samples(smc_result["traj"][0], smc_result["log_weights_traj"][0], propagate, lambdas[0], rng)
    last = refine_samples(smc_result["traj"][-1], smc_result["log_weights_traj"][-1], propagate, lambdas[-1], rng)
    return first, last
