"""BAR free-energy estimation with a bootstrapped pessimistic uncertainty
(counterpart of timemachine_tpu/fe/bar.py), on the port's MBAR.

Works and u_kln matrices are small host-side arrays: the estimators take and
return numpy, and compute in f64 on the CPU. Callers map NaN energies to
+inf before these run (fe/free_energy.py estimate_free_energy_bar).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F
from scipy.stats import normaltest

from timemachine_torch.fe.mbar import DEFAULT_MAXIMUM_ITERATIONS, DEFAULT_RELATIVE_TOLERANCE, MBAR, solve_mbar

DG_KEY = "Delta_f"
DG_ERR_KEY = "dDelta_f"

logger = logging.getLogger(__name__)


def EXP(w_raw):
    """Exponential averaging (Zwanzig) of forward works; None entries skipped."""
    w = torch.tensor([ww for ww in w_raw if ww is not None], dtype=torch.float64)
    return float(np.log(w.numel()) - torch.logsumexp(-w, dim=0))


def BARzero(w, deltaF):
    """Self-consistency residual of BAR, zero at deltaF = dG: w = (w_f, w_r)
    tensors; differentiable in both, as dG_dw needs."""
    w_f, w_r = w[0], w[1]
    bias = np.log(len(w_f) / len(w_r))
    log_fermi_fwd = F.logsigmoid(-(bias + w_f - deltaF))
    log_fermi_rev = F.logsigmoid(bias - w_r - deltaF)
    return torch.logsumexp(log_fermi_fwd, dim=0) - torch.logsumexp(log_fermi_rev, dim=0)


def dG_dw(w):
    """d(BAR estimate)/d(works), (2, N), by implicit differentiation of
    BARzero at its root."""
    w = np.asarray(w, dtype=np.float64)
    dG, _ = bar(w[0], w[1], compute_uncertainty=False)
    wt = torch.tensor(w, requires_grad=True)
    dF = torch.tensor(float(dG), dtype=torch.float64, requires_grad=True)
    residual_w, residual_dF = torch.autograd.grad(BARzero(wt, dF), (wt, dF))
    return (-residual_w / residual_dF).numpy()


# -- u_kln plumbing -----------------------------------------------------------


def ukln_to_ukn(u_kln):
    """(2, 2, N) pair matrix -> ((2, 2N) u_kn, N_k), state 0's samples first."""
    u_kln = np.asarray(u_kln)
    assert u_kln.shape[:2] == (2, 2)
    return np.hstack([u_kln[0], u_kln[1]]), np.full(2, u_kln.shape[2])


def _pair_mbar(u_kln, initial_f_k=None, maximum_iterations=DEFAULT_MAXIMUM_ITERATIONS):
    u_kn, n_k = ukln_to_ukn(u_kln)
    return MBAR(
        u_kn, n_k, initial_f_k=initial_f_k, maximum_iterations=maximum_iterations,
        relative_tolerance=DEFAULT_RELATIVE_TOLERANCE,
    )


def df_and_err_from_u_kln(u_kln, maximum_iterations: int = DEFAULT_MAXIMUM_ITERATIONS):
    results = _pair_mbar(u_kln, maximum_iterations=maximum_iterations).compute_free_energy_differences()
    return results[DG_KEY][0, 1], results[DG_ERR_KEY][0, 1]


def df_from_u_kln(u_kln, initial_f_k=None, maximum_iterations: int = DEFAULT_MAXIMUM_ITERATIONS):
    mbar = _pair_mbar(u_kln, initial_f_k=initial_f_k, maximum_iterations=maximum_iterations)
    return mbar.compute_free_energy_differences(compute_uncertainty=False)[DG_KEY][0, 1]


def bar(w_F, w_R, compute_uncertainty: bool = True):
    """BAR from equal-length forward and reverse works, as a two-state MBAR
    problem (u_kk = 0, the works off the diagonal)."""
    n = len(w_F)
    assert len(w_R) == n, "bar() requires equal forward/reverse sample counts"
    u_kln = np.zeros((2, 2, n))
    u_kln[0, 1] = w_F
    u_kln[1, 0] = w_R
    if compute_uncertainty:
        return df_and_err_from_u_kln(u_kln)
    return df_from_u_kln(u_kln), None


def works_from_ukln(u_kln):
    """Forward and reverse works of a (2, 2, N) pair matrix."""
    assert np.asarray(u_kln).shape[:2] == (2, 2)
    return u_kln[0, 1] - u_kln[0, 0], u_kln[1, 0] - u_kln[1, 1]


# -- uncertainty --------------------------------------------------------------


def bootstrap_bar(u_kln, n_bootstrap: int = 100, maximum_iterations: int = DEFAULT_MAXIMUM_ITERATIONS):
    """(dF, its MBAR error, n_bootstrap frame-resampled dF), each replicate
    warm-started from the full-data solution; frames drawn from numpy's
    default_rng(2022), as in the JAX package. The replicates are solved
    together, each to the tolerance it would reach alone."""
    df_full, ddf_full = df_and_err_from_u_kln(u_kln, maximum_iterations=maximum_iterations)
    n = u_kln.shape[2]
    rng = np.random.default_rng(2022)
    draws = [rng.integers(0, n, size=n) for _ in range(n_bootstrap)]
    if not draws:
        return df_full, ddf_full, np.zeros(0)
    u_bkn = np.stack([ukln_to_ukn(u_kln[:, :, d])[0] for d in draws])
    f_bk, _ = solve_mbar(
        u_bkn, np.full(2, n), initial_f_k=np.array([0.0, df_full]), relative_tolerance=DEFAULT_RELATIVE_TOLERANCE,
        maximum_iterations=maximum_iterations,
    )
    return df_full, ddf_full, (f_bk[:, 1] - f_bk[:, 0]).cpu().numpy()


def bar_with_pessimistic_uncertainty(u_kln, n_bootstrap=100, maximum_iterations: int = DEFAULT_MAXIMUM_ITERATIONS):
    """dF with error max(MBAR's analytic error, the bootstrap's standard deviation)."""
    df, ddf, replicates = bootstrap_bar(u_kln, n_bootstrap=n_bootstrap, maximum_iterations=maximum_iterations)
    if len(replicates) >= 8:
        test = normaltest(replicates)
        if test.pvalue < 1e-3:
            logger.warning(f"bootstrapped errors non-normal: {test}")
    if not np.isfinite(ddf):
        logger.warning(f"BAR error estimate is not finite, setting to zero: {ddf}")
        ddf = 0.0
    return df, np.maximum(ddf, replicates.std())


def pair_overlap_from_ukln(
    u_kln, maximum_iterations=DEFAULT_MAXIMUM_ITERATIONS, relative_tolerance=DEFAULT_RELATIVE_TOLERANCE
) -> float:
    """The normalized off-diagonal MBAR overlap, in [0, 1]."""
    u_kn, n_k = ukln_to_ukn(u_kln)
    mbar = MBAR(u_kn, n_k, maximum_iterations=maximum_iterations, relative_tolerance=relative_tolerance)
    return float(np.clip(2 * mbar.compute_overlap()["matrix"][0, 1], 0.0, 1.0))


# -- multi-window convergence diagnostics -------------------------------------


def df_from_ukln_by_lambda(ukln_by_lambda):
    """Total dF over a ladder of window pair matrices, errors in quadrature."""
    per_window = np.array([df_and_err_from_u_kln(pair) for pair in ukln_by_lambda])
    return per_window[:, 0].sum(), np.linalg.norm(per_window[:, 1])


def compute_fwd_and_reverse_df_over_time(ukln_by_lambda, frames_per_step: int = 100):
    """dF over growing frame prefixes, forward and time-reversed: flat,
    agreeing curves indicate convergence."""
    assert ukln_by_lambda.ndim == 4 and ukln_by_lambda.shape[1] == 2
    total_frames = ukln_by_lambda.shape[-1]
    assert total_frames >= frames_per_step, "fewer samples than frames_per_step"

    def prefix_curve(u):
        pairs = [df_from_ukln_by_lambda(u[..., :n]) for n in range(frames_per_step, total_frames + 1, frames_per_step)]
        arr = np.array(pairs)
        return arr[:, 0], arr[:, 1]

    fwd_df, fwd_err = prefix_curve(ukln_by_lambda)
    rev_df, rev_err = prefix_curve(np.flip(ukln_by_lambda, 3))
    return fwd_df, fwd_err, rev_df, rev_err
